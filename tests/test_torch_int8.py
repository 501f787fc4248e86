"""The port's int8 serving (pocketflow_tpu_torch/ops/int8_ops.py) against the
JAX package's on the CPU, inputs from a numpy seed, parameters bridged:

* symmetric per-channel weight codes and scales bit-equal to JAX's;
* ``int8_contract`` through each layer's contraction (dense, 1x1, 3x3 'SAME'
  at stride 1 and 2, 5x5 'VALID', 7x7 'SAME' stride 2, depthwise 3x3): the
  activation codes and the int32 accumulators equal to JAX's, the float
  outputs within 1 fp32 ulp;
* ``calibrate``'s scales on a bridged ConvNet: the stem's equal, the later
  layers' within 1e-5 relative (their inputs went through fp32 convs summed
  in another order);
* the ``Int8ServingPolicy`` forward of ConvNet against JAX's with the same
  codes and scales: within 1 fp32 ulp of the largest logit (every
  contraction is an exact integer sum, the rest the same fp32 operations);
* the depthwise signature (the channel axis is NCHW's 1): skipped at
  multiplier 1 and 2, a grayscale stem and a width that is not a multiple
  kept in int8; a skipped depthwise conv bit-equal to the float path;
* the policy falls through without scales; coverage finds a missing site;
* ``int8_matmul``'s padding (M > 16, K to a multiple of 8, N of 16) exact
  at widths 60 -> 20, 14 -> 62 and 16 -> 40, against the unpadded product;
* the latency benchmark reports the device it ran on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.nn.layers import compression as jcompression
from pocketflow_tpu.ops import int8_ops as jint8
from pocketflow_tpu_torch.core.bridge import load_jax_numpy
from pocketflow_tpu_torch.nn import layers as tl
from pocketflow_tpu_torch.ops import int8_ops as tint8

torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize('shape', [(3, 3, 8, 16), (1, 1, 32, 24), (64, 10), (3, 3, 1, 12)])
def test_symmetric_weight_codes_and_scales_equal_jax(shape):
    k = (np.random.default_rng(0).normal(size=shape) * 0.3).astype(np.float32)
    k.reshape(-1, shape[-1])[:, 1] = 0.0  # an all-zero channel: the 1e-8 floor
    jc, js = jint8.quantize_weights_symmetric(jnp.asarray(k))
    tc, ts = tint8.quantize_weights_symmetric(torch.from_numpy(k))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# (name, kernel shape HWIO, strides, padding, input NHWC)
CONTRACTIONS = [
    ('dense', (40, 12), None, None, (5, 40)),
    ('1x1', (1, 1, 16, 24), (1, 1), 'SAME', (2, 7, 9, 16)),
    ('3x3 SAME s1', (3, 3, 8, 16), (1, 1), 'SAME', (2, 9, 7, 8)),
    ('3x3 SAME s2', (3, 3, 8, 16), (2, 2), 'SAME', (2, 9, 8, 8)),
    ('5x5 VALID', (5, 5, 3, 10), (1, 1), 'VALID', (2, 11, 12, 3)),
    ('7x7 SAME s2', (7, 7, 3, 8), (2, 2), 'SAME', (2, 15, 16, 3)),
    ('depthwise 3x3 s2', (3, 3, 1, 12), (2, 2), 'SAME', (2, 9, 10, 12)),
]


def _layers(name, kshape, strides, padding):
    """(port contraction fn, JAX contraction fn(xv, kv, acc_dtype))."""
    if name == 'dense':
        return tl.PFDense.dense_fn, lambda xv, kv, acc: jax.lax.dot_general(
            xv, kv, (((xv.ndim - 1,), (0,)), ((), ())), preferred_element_type=acc)
    groups = kshape[-1] if name.startswith('depthwise') else 1
    if groups > 1:
        layer = tl.PFDepthwiseConv(kshape[-1], kshape[:2], strides, padding=padding)
    else:
        layer = tl.PFConv(kshape[2], kshape[3], kshape[:2], strides, padding=padding)
    return layer.conv_fn, lambda xv, kv, acc: jax.lax.conv_general_dilated(
        xv, kv, window_strides=strides, padding=padding,
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'), feature_group_count=groups,
        preferred_element_type=acc)


@pytest.mark.parametrize('case', CONTRACTIONS, ids=[c[0] for c in CONTRACTIONS])
def test_int8_contract_accumulators_equal_jax(case):
    name, kshape, strides, padding, xshape = case
    rng = np.random.default_rng(1)
    x = rng.normal(size=xshape).astype(np.float32)
    k = (rng.normal(size=kshape) * 0.2).astype(np.float32)
    x_scale = float(np.abs(x).max()) * 0.8 / 127.0  # some codes clip at +-127
    t_fn, j_fn = _layers(name, kshape, strides, padding)
    jcodes, jscale = jint8.quantize_weights_symmetric(jnp.asarray(k))
    tcodes, tscale = tint8.quantize_weights_symmetric(torch.from_numpy(k))
    tx = torch.from_numpy(x) if name == 'dense' else _nchw(x)
    # the activation codes
    jxq = jnp.clip(jnp.round(jnp.asarray(x) / jnp.float32(x_scale)), -127, 127).astype(jnp.int8)
    captured = {}

    def t_capture(xq, codes, acc_dtype):
        captured['xq'], captured['acc'] = xq, t_fn(xq, codes, acc_dtype)
        return captured['acc']

    got = tint8.int8_contract(tx, tcodes, tscale, x_scale, t_capture)
    want = jint8.int8_contract(jnp.asarray(x), jcodes, jscale, jnp.float32(x_scale), j_fn)
    jacc = np.asarray(j_fn(jxq, jcodes, jnp.int32))
    to_nhwc = (lambda t: t.numpy()) if name == 'dense' else _nhwc
    np.testing.assert_array_equal(to_nhwc(captured['xq']), np.asarray(jxq))
    assert captured['acc'].dtype == torch.int32
    np.testing.assert_array_equal(to_nhwc(captured['acc']), jacc)
    np.testing.assert_array_max_ulp(to_nhwc(got), np.asarray(want), maxulp=1)


def _convnet(seed=0):
    """(JAX ConvNet, its variables, the bridged port ConvNet, images NHWC)."""
    from pocketflow_tpu.nets.convnet_at_fmnist import ConvNet as JConvNet
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ConvNet
    x = (np.random.default_rng(seed).normal(size=(4, 28, 28, 1)) * 0.5).astype(np.float32)
    jm = JConvNet(nb_classes=10, dtype=jnp.float32)
    variables = jax.device_get(jax.jit(lambda: jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                                                       train=False))())
    tm = ConvNet(10, dtype=torch.float32)
    load_jax_numpy(tm, variables['params'], {})
    return jm, variables, tm.eval(), x


def test_calibrate_scales_match_jax():
    jm, variables, tm, x = _convnet()
    want = jint8.calibrate(jm, variables, [jnp.asarray(x)])
    got = tint8.calibrate(tm, [torch.from_numpy(x)])
    assert sorted(got) == sorted(want) == ['conv1', 'conv2', 'fc3', 'fc4']
    assert got['conv1'] == want['conv1']  # the images themselves
    for path in want:
        assert got[path] == pytest.approx(want[path], rel=1e-5), path


def test_int8_policy_forward_matches_jax():
    jm, variables, tm, x = _convnet(1)
    scales = jint8.calibrate(jm, variables, [jnp.asarray(x)])
    jq = jint8.quantize_model_weights(variables['params'])
    tq = tint8.quantize_model_weights(tm)
    assert sorted(tq) == sorted(jq)
    for path, (codes, scale) in tq.items():
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jq[path][0]))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jq[path][1]))
    with jcompression(jint8.Int8ServingPolicy(jq, scales)):
        want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad(), tl.compression(tint8.Int8ServingPolicy(tq, scales)):
        got = tm(torch.from_numpy(x)).numpy()
    ulp = np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
    assert not np.array_equal(got, ref)  # int8 really ran


def test_int8_policy_depthwise_signature():
    """HWIO kernels with I == 1 whose O is a multiple of the input's channels
    (NCHW axis 1) are skipped; a conv on one input channel (grayscale stem)
    and a non-multiple O stay in int8."""
    weight_q = {p: (torch.zeros(s, dtype=torch.int8), torch.ones(s[-1])) for p, s in (
        ('dw', (3, 3, 1, 16)), ('dw2', (3, 3, 1, 32)), ('conv', (3, 3, 16, 32)),
        ('gray', (5, 5, 1, 32)), ('odd', (3, 3, 1, 24)))}
    policy = tint8.Int8ServingPolicy(weight_q, {p: 0.1 for p in weight_q})
    calls = []

    def fn(xq, codes, acc_dtype):
        calls.append(acc_dtype)
        return torch.zeros((1, codes.shape[-1], 1, 1), dtype=torch.int32)

    x16, x1 = torch.zeros((1, 16, 8, 8)), torch.zeros((1, 1, 8, 8))
    assert policy.run_contraction('dw', x16, torch.zeros(3, 3, 1, 16), fn) is None
    assert policy.run_contraction('dw2', x16, torch.zeros(3, 3, 1, 32), fn) is None
    assert policy.run_contraction('conv', x16, torch.zeros(3, 3, 16, 32), fn) is not None
    assert policy.run_contraction('gray', x1, torch.zeros(5, 5, 1, 32), fn) is not None
    assert policy.run_contraction('odd', x16, torch.zeros(3, 3, 1, 24), fn) is not None
    assert calls == [torch.int32] * 3


def test_skipped_depthwise_is_the_float_path():
    """skip_depthwise=True: a lone depthwise conv is bit-equal to the float
    path; False: it runs in int8 (differs, within 5% of the largest output)."""
    layer = tl.PFDepthwiseConv(16, dtype=torch.float32)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 16, 8, 8)).astype(np.float32))
    with torch.no_grad():
        ref = layer(x)
        weight_q = {'': tint8.quantize_weights_symmetric(layer.kernel)}
        scales = {'': float(x.abs().max()) / 127.0}
        with tl.compression(tint8.Int8ServingPolicy(weight_q, scales, skip_depthwise=True)):
            skipped = layer(x)
        with tl.compression(tint8.Int8ServingPolicy(weight_q, scales, skip_depthwise=False)):
            quantized = layer(x)
    assert torch.equal(skipped, ref)
    assert not torch.equal(quantized, ref)
    np.testing.assert_allclose(quantized.numpy(), ref.numpy(), atol=0.05 * float(ref.abs().max()))


def test_policy_falls_through_without_scales_and_coverage():
    from pocketflow_tpu_torch.nets.mobilenet import MobileNetV1
    _, _, tm, x = _convnet(2)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x))
        with tl.compression(tint8.Int8ServingPolicy({}, {})):  # nothing quantized
            out = tm(torch.from_numpy(x))
    assert torch.equal(out, ref)
    model = MobileNetV1(10, 0.25, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 32, 32, 3))
                              .astype(np.float32))
    scales = tint8.calibrate(model, [images])
    weight_q = tint8.quantize_model_weights(model)
    assert len(weight_q) == len(scales) == 28
    report = tint8.verify_quant_coverage(model, images, weight_q, scales)
    assert report == {'unquantized_weights': [], 'uncalibrated': []}
    some = sorted(weight_q)[3]
    report = tint8.verify_quant_coverage(
        model, images, {k: v for k, v in weight_q.items() if k != some}, scales)
    assert report == {'unquantized_weights': [some], 'uncalibrated': []}


@pytest.mark.parametrize('m,k,n', [(32, 60, 20), (5, 14, 62), (17, 8, 8), (100, 16, 40)])
def test_int8_matmul_padding_is_exact(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8))
    got = tint8.int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, (a.long() @ b.long()).int())
    if m > 16:  # the CPU's _int_mm takes the unpadded operands too
        assert torch.equal(got, torch._int_mm(a, b))


def test_quantized_latency_benchmark_names_its_device():
    from pocketflow_tpu_torch.tools.benchmark import calc_quantized_inference_time
    _, _, tm, _ = _convnet(3)
    result = calc_quantized_inference_time(tm, (2, 28, 28, 1), nb_calib_batches=1,
                                           nb_warmup=1, nb_timed=2)
    assert result['float']['device'] == result['int8']['device'] == 'cpu'
    assert result['int8']['latency_ms'] > 0 and result['speedup'] > 0
