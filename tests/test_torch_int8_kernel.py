"""The int8 serving kernel's plain version, its weight packing and the
prepared policy (pocketflow_tpu_torch/ops/int8_ops.py), on the CPU:

* ``int8_conv``'s plain version at every distinct site geometry of ResNet-50
  and MobileNet-v1 (both stems, 1x1 at stride 1 and 2, 3x3 at stride 1 and
  2, the dense layer with its bias) at batch 2 and a reduced spatial size,
  and at 'VALID' padding, K and N off the multiples of 8 and 16, odd shrunk
  widths and an fp32 input: the layer's output through the prepared site
  equals ``int8_contract`` followed by the layer's bias add and cast, bit
  for bit (the route before the kernel); and the logits of ResNet-50 and
  MobileNet-v1 at full width (batch 2, 64x64) through all their int8 sites,
  equal to that route's;
* the K-major packing with each tap's channels padded to Cp (16) and K to
  whole 128-deep stages: zeros in the padding, past K and past the output
  channels, the codes back exactly;
* the kernel's layout steps through their plain versions (the padded codes,
  laid out wide for the stems and subsampled for strided 1x1 convs, their
  im2col rows against the padded packing, the split-K partial sums and
  their sum) give ``int8_conv_plain``'s bits at every site geometry above, at the plan's split of K and at others; the tile plan of every
  site of ResNet-50 and MobileNet-v1 at batch 64, 224x224, is a pure
  function of the shapes, with K split for the dense layers at M = 64; a
  split-K sum over uneven splits equals the unsplit int32 sum; and planted
  faults (a pad channel coded from x, a split that drops its partial) fail
  these checks;
* a prepared ``Int8ServingPolicy`` makes no tensor from host values in a
  forward (no host-to-device copy on the card), and every site it prepared
  holds its tensors on the input's device;
* the kernel's wrapper refuses inputs it does not take, on every device.
"""

import numpy as np
import pytest
import torch

from pocketflow_tpu_torch.nn import layers as tl
from pocketflow_tpu_torch.ops import int8_ops as tint8

torch.set_num_threads(2)


class _ContractPolicy(tl.CompressionPolicy):
    """The int8 route before the kernel: int8_contract on each site from a
    host scale, fp32 out, then the layer's bias added as the layer adds it
    (an output the policy returns holds the bias) and the layer's cast."""

    def __init__(self, weight_q, act_scales):
        self.weight_q, self.act_scales = weight_q, act_scales

    def run_contraction(self, path, x, kernel, contract_fn, layer=None):
        if path not in self.act_scales:
            return None
        codes, w_scale = self.weight_q[path]
        y = tint8.int8_contract(x, codes, w_scale, self.act_scales[path], contract_fn)
        if layer.bias is None:
            return y
        bias = layer.bias.to(y.dtype)
        return y + (bias[:, None, None] if y.dim() == 4 else bias)


# (name, HWIO kernel or [in, out], strides, padding, input spatial size, input dtype, bias)
SITES = [
    ('resnet50 stem 7x7 s2', (7, 7, 3, 64), (2, 2), 'SAME', 15, torch.bfloat16, False),
    ('resnet50 1x1 64->64', (1, 1, 64, 64), (1, 1), 'SAME', 7, torch.bfloat16, False),
    ('resnet50 3x3 64->64', (3, 3, 64, 64), (1, 1), 'SAME', 7, torch.bfloat16, False),
    ('resnet50 1x1 64->256', (1, 1, 64, 256), (1, 1), 'SAME', 7, torch.bfloat16, False),
    ('resnet50 1x1 256->64', (1, 1, 256, 64), (1, 1), 'SAME', 7, torch.bfloat16, False),
    ('resnet50 1x1 s2 256->512', (1, 1, 256, 512), (2, 2), 'SAME', 7, torch.bfloat16, False),
    ('resnet50 3x3 s2 128->128', (3, 3, 128, 128), (2, 2), 'SAME', 7, torch.bfloat16, False),
    ('resnet50 3x3 512->512', (3, 3, 512, 512), (1, 1), 'SAME', 3, torch.bfloat16, False),
    ('resnet50 1x1 512->2048', (1, 1, 512, 2048), (1, 1), 'SAME', 3, torch.bfloat16, False),
    ('resnet50 dense 2048->1000', (2048, 1000), None, None, None, torch.bfloat16, True),
    ('mobilenet stem 3x3 s2', (3, 3, 3, 32), (2, 2), 'SAME', 15, torch.bfloat16, False),
    ('mobilenet 1x1 32->64', (1, 1, 32, 64), (1, 1), 'SAME', 9, torch.bfloat16, False),
    ('mobilenet 1x1 1024->1024', (1, 1, 1024, 1024), (1, 1), 'SAME', 3, torch.bfloat16, False),
    ('mobilenet dense 1024->1000', (1024, 1000), None, None, None, torch.bfloat16, True),
    ('3x3 VALID', (3, 3, 16, 24), (1, 1), 'VALID', 8, torch.bfloat16, False),
    ('3x3 s2 VALID', (3, 3, 16, 24), (2, 2), 'VALID', 9, torch.bfloat16, False),
    ('K, N off the multiples', (3, 3, 12, 40), (1, 1), 'SAME', 6, torch.bfloat16, False),
    ('odd shrunk 1x1', (1, 1, 37, 53), (1, 1), 'SAME', 5, torch.bfloat16, False),
    ('odd shrunk 3x3 s2', (3, 3, 19, 23), (2, 2), 'SAME', 8, torch.bfloat16, False),
    ('odd dense', (77, 9), None, None, None, torch.bfloat16, False),
    ('fp32 3x3 s2', (3, 3, 24, 40), (2, 2), 'SAME', 9, torch.float32, False),
    ('conv with bias', (3, 3, 8, 16), (1, 1), 'SAME', 6, torch.bfloat16, True),
    ('resnet50 s2d stem 4x4 on 12 channels', (4, 4, 12, 64), (1, 1), 'SAME', 8, torch.bfloat16,
     False),
    ('fp32 odd dense with bias', (45, 30), None, None, None, torch.float32, True),
]


def _site_layer(kshape, strides, padding, dtype, bias, seed):
    if len(kshape) == 2:
        layer = tl.PFDense(kshape[0], kshape[1], use_bias=bias, dtype=dtype)
    else:
        layer = tl.PFConv(kshape[2], kshape[3], kshape[:2], strides, use_bias=bias, dtype=dtype,
                          padding=padding)
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    if bias:
        with torch.no_grad():
            layer.bias.normal_(generator=torch.Generator().manual_seed(seed + 1))
    return layer.eval()


def _site_input(kshape, size, dtype, seed, batch=2):
    rng = np.random.default_rng(seed)
    if len(kshape) == 2:
        x = rng.normal(size=(batch, kshape[0]))
        return torch.from_numpy(x.astype(np.float32)).to(dtype)
    x = rng.normal(size=(batch, size, size + 1, kshape[2])).astype(np.float32)
    return torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)  # channels-last NCHW


@pytest.mark.parametrize('case', SITES, ids=[c[0] for c in SITES])
def test_fused_plain_equals_contract_then_layer_cast(case):
    name, kshape, strides, padding, size, dtype, bias = case
    seed = sum(map(ord, name)) % 1000
    layer = _site_layer(kshape, strides, padding, dtype, bias, seed)
    x = _site_input(kshape, size, dtype, seed)
    x_scale = float(x.float().abs().max()) * 0.8 / 127.0  # some codes clip at +-127
    weight_q = {'': tint8.quantize_weights_symmetric(layer.kernel)}
    tint8.reset_counters()
    with torch.no_grad():
        with tl.compression(_ContractPolicy(weight_q, {'': x_scale})):
            want = layer(x)
        policy = tint8.Int8ServingPolicy(weight_q, {'': x_scale})
        with tl.compression(policy):
            got = layer(x)
        # the wrapper itself (the plain version on the CPU) on the prepared
        # site: the layer's bias and dtype are the site's
        direct = tint8.int8_conv(x, policy.sites['', x.device])
    assert got.dtype == want.dtype == direct.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want), name
    assert torch.equal(direct, want), name
    assert got.is_contiguous(memory_format=torch.channels_last) or got.dim() == 2
    # the site writes the layer's dtype and adds its bias, a dense layer's too
    site = policy.sites['', x.device]
    assert site.out_dtype == dtype and (site.bias is not None) == bias
    if bias:
        assert torch.equal(site.bias[:kshape[-1]], layer.bias.float())
        assert not site.bias[kshape[-1]:].any() and site.bias.shape == site.scale.shape
    assert tint8.counters() == {'int8_conv': 0, 'int8_plain_cuda': 0, 'int8_depthwise': 0,
                                'plain': 2}
    assert not torch.equal(got, layer(x))  # int8 really ran


@pytest.mark.parametrize('shape', [(7, 7, 3, 64), (1, 1, 37, 53), (3, 3, 19, 200), (2048, 1000),
                                   (77, 9), (1, 1, 32, 64), (3, 3, 3, 32), (4, 4, 12, 64)])
def test_weight_packing_round_trips(shape):
    gen = torch.Generator().manual_seed(sum(shape))
    codes = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    packed = tint8.pack_weights(codes)
    kh, kw, cin, cout = (1, 1) + shape if len(shape) == 2 else shape
    # the stems lay a window row's taps out as channels: [kh, 1, kw C, out]
    wide = tint8.wide_taps(shape)
    assert wide == (shape in ((7, 7, 3, 64), (3, 3, 3, 32)))
    if wide:
        kw, cin = 1, kw * cin
    cp = tint8.padded_channels(cin)
    k = kh * kw * cp
    npad, kp = packed.shape
    tile = 64 if cout <= 64 else 128 if cout <= 128 else 256
    assert tint8.tile_n(cout) == tile and cp % 16 == 0 and 0 <= cp - cin < 16
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert npad % tile == 0 and npad - cout < tile and kp % 128 == 0 and kp - k < 128
    # K-major: row n is output channel n's codes in the HWIO flattening
    # order, each tap's channels padded to cp with zeros
    taps = packed[:cout, :k].reshape(cout, kh, kw, cp)
    assert torch.equal(taps[..., :cin].permute(1, 2, 3, 0).reshape(shape), codes)
    assert torch.equal(taps[..., :cin].permute(1, 2, 3, 0), codes.reshape(kh, kw, cin, cout))
    assert not taps[..., cin:].any()
    assert not packed[cout:].any() and not packed[:, k:].any()


def _prepared_site(case):
    """The case's layer, input and prepared site (as the policy prepares it)."""
    name, kshape, strides, padding, size, dtype, bias = case
    seed = sum(map(ord, name)) % 1000
    layer = _site_layer(kshape, strides, padding, dtype, bias, seed)
    x = _site_input(kshape, size, dtype, seed)
    x_scale = float(x.float().abs().max()) * 0.8 / 127.0  # some codes clip at +-127
    policy = tint8.Int8ServingPolicy({'': tint8.quantize_weights_symmetric(layer.kernel)},
                                     {'': x_scale})
    with torch.no_grad(), tl.compression(policy):
        layer(x)
    return x, policy.sites['', x.device]


def _layout_gives_plain(x, site, splits, codes_fn=tint8.padded_codes_plain,
                        sum_fn=tint8.split_k_sum_plain):
    """The kernel's layout, step by step through `codes_fn` and `sum_fn`:
    the padded codes hold x's codes and code 0 past C, and their rows against
    the padded packing in `splits` splits of K, summed and rescaled, give
    int8_conv_plain's bits."""
    codes = codes_fn(x, site)
    c = x.shape[-1] if site.dense else x.shape[1]
    want_codes = torch.clamp(torch.round(x.float() / site.x_scale), -127, 127).to(torch.int8)
    if not site.dense:
        want_codes = want_codes.permute(0, 2, 3, 1)
    if tint8.subsampled(tuple(site.codes.shape), site.strides):
        # a strided 1x1 conv: the codes of the pixels it reads
        want_codes = want_codes[:, ::site.strides[0], ::site.strides[1]]
    if tint8.wide_taps(tuple(site.codes.shape)):
        # (n, h, wo) holds the codes of x[n, h, wo sw - left + j, :], j < kw
        kh, kw = site.codes.shape[:2]
        n, h, w, _ = want_codes.shape
        _, wo, _, left = tint8._conv_geometry(h, w, kh, kw, site.strides, site.padding)
        wide = torch.zeros((n, h, wo, kw, c), dtype=torch.int8)
        for o in range(wo):
            for j in range(kw):
                col = o * site.strides[1] - left + j
                if 0 <= col < w:
                    wide[:, :, o, j] = want_codes[:, :, col]
        want_codes, c = wide.reshape(n, h, wo, kw * c), kw * c
    if codes.shape[-1] != tint8.padded_channels(c) or codes[..., c:].any() \
            or not torch.equal(codes[..., :c], want_codes):
        return False
    packed = tint8.pack_weights(site.codes)
    rows = tint8.padded_rows_plain(codes, site)
    cout = site.codes.shape[-1]
    acc = sum_fn(tint8.split_k_partials_plain(rows, packed, cout, splits))
    y = acc.float() * site.scale[:cout]
    y = (y if site.bias is None else y + site.bias[:cout]).to(site.out_dtype)
    want = tint8.int8_conv_plain(x, site)
    return torch.equal(y, want.permute(0, 2, 3, 1).reshape(-1, cout) if want.dim() == 4 else want)


@pytest.mark.parametrize('case', SITES, ids=[c[0] for c in SITES])
def test_kernel_layout_gives_the_plain_bits(case):
    """The padded codes and the padded packing give int8_conv_plain bit for
    bit, through the plain layout functions, at the site's own plan and at
    other splits of K (uneven ones included)."""
    x, site = _prepared_site(case)
    m = x.shape[0] if site.dense else int(np.prod(tint8.int8_conv_plain(x, site).shape)) \
        // site.codes.shape[-1]
    plan, counters = site.plans[m]  # chosen when the policy prepared the site
    assert counters is None and plan == tint8.tile_plan(m, site.codes.shape[-1],
                                                        tint8.pack_weights(site.codes).shape[1])
    nk = -(-tint8.pack_weights(site.codes).shape[1] // 128)
    for splits in sorted({1, plan.splits, min(2, nk), min(3, nk), nk}):
        assert _layout_gives_plain(x, site, splits), (case[0], splits)
    assert torch.equal(tint8.int8_conv_layout_plain(x, site), tint8.int8_conv_plain(x, site))


def _serving_sites(net):
    """(kernel shape, input shape) of every int8 site of a serving net at
    batch 64, 224x224: recorded at batch 2, 64x64, where every spatial size
    is 64 / 224 of its size at 224 (the nets halve it five times)."""
    from pocketflow_tpu_torch.nets.mobilenet import MobileNetV1
    from pocketflow_tpu_torch.nets.resnet import ResNetImageNet
    model = (ResNetImageNet(resnet_size=50, nb_classes=1000, dtype=torch.bfloat16)
             if net == 'resnet50' else MobileNetV1(nb_classes=1000, dtype=torch.bfloat16))
    model.reset_parameters(torch.Generator().manual_seed(0))
    sites = []

    class Recorder(tl.CompressionPolicy):
        def run_contraction(self, path, x, kernel, contract_fn, layer=None):
            depthwise = kernel.dim() == 4 and kernel.shape[-2] == 1 and x.shape[1] > 1
            if not depthwise:
                shape = ((64, x.shape[1]) if x.dim() == 2 else
                         (64, x.shape[1], x.shape[2] * 7 // 2, x.shape[3] * 7 // 2))
                sites.append((tuple(kernel.shape), shape, getattr(layer, 'strides', (1, 1)),
                              getattr(layer, 'padding', 'SAME')))
            return None

    images = torch.zeros((2, 64, 64, 3))
    with torch.no_grad(), tl.compression(Recorder()):
        model.eval()(images)
    return sites


@pytest.mark.parametrize('net', ['resnet50', 'mobilenet_v1'])
def test_tile_plan_of_the_serving_nets(net):
    """Each site's plan at batch 64, 224x224 is a pure function of its
    shapes (the same for a site made anew, and for another site of the same
    shapes), and K is split for the dense layer at M = 64 (1000 outputs:
    four 256-wide column tiles for 132 SMs), not for the sites with more
    tiles than SMs."""
    sites = _serving_sites(net)
    assert len(sites) == {'resnet50': 54, 'mobilenet_v1': 15}[net]
    gen = torch.Generator().manual_seed(1)
    for kshape, x_shape, strides, padding in sites:
        codes = torch.randint(-127, 128, kshape, generator=gen, dtype=torch.int8)
        made = [tint8.make_site(codes, torch.ones(kshape[-1]), 0.1, 'cpu', strides, padding,
                                x_shape=x_shape) for _ in range(2)]
        (m, (plan, _)), = made[0].plans.items()
        assert made[1].plans[m][0] == plan
        kp = tint8.pack_weights(codes).shape[1]
        assert tint8.tile_plan(m, kshape[-1], kp) == plan
        assert plan.bn == tint8.tile_n(kshape[-1]) and plan.bm in (64, 128)
        assert 1 <= plan.splits <= -(-kp // 128)
        tiles = -(-m // plan.bm) * -(-kshape[-1] // plan.bn)
        if len(kshape) == 2:
            assert m == 64 and plan.bm == 64 and plan.splits > 1, (kshape, plan)
        elif -(-m // 128) * -(-kshape[-1] // plan.bn) >= 2 * 132:
            assert plan == tint8.TilePlan(128, plan.bn, 1), (kshape, x_shape, plan)
        assert tiles * plan.splits >= 1


@pytest.mark.parametrize('m,kp,cout', [(64, 2048, 1000), (37, 640, 70), (130, 896, 64),
                                       (9, 384, 20)])
def test_split_k_sum_is_exact_over_uneven_splits(m, kp, cout):
    rng = np.random.default_rng(m + kp)
    rows = torch.from_numpy(rng.integers(-127, 128, (m, kp)).astype(np.int8))
    packed = torch.from_numpy(rng.integers(-127, 128, (tint8._padded_cout(cout), kp))
                              .astype(np.int8))
    whole = tint8.int8_matmul(rows, packed[:cout].t())
    nk = kp // 128
    for splits in range(1, nk + 1):
        bounds = tint8.split_k_bounds(kp, splits)
        # contiguous whole stages from 0 to kp, uneven where splits does not divide nk
        assert bounds[0][0] == 0 and bounds[-1][1] == kp and len(bounds) == splits
        assert all(k1 == k0n for (_, k1), (k0n, _) in zip(bounds, bounds[1:]))
        assert all(k0 % 128 == 0 and k1 > k0 for k0, k1 in bounds)
        partials = tint8.split_k_partials_plain(rows, packed, cout, splits)
        assert partials.dtype == torch.int32 and partials.shape == (splits, m, cout)
        assert torch.equal(tint8.split_k_sum_plain(partials), whole), splits
        # the sum is exact in any order (the last unit to arrive adds the rest)
        assert torch.equal(tint8.split_k_sum_plain(partials.flip(0)), whole)


def _pad_coded_from_x(x, site):
    codes = tint8.padded_codes_plain(x, site)
    c = x.shape[-1] if site.dense else x.shape[1]
    if tint8.wide_taps(tuple(site.codes.shape)):
        c *= site.codes.shape[1]
    pad = codes.shape[-1] - c
    assert 0 < pad <= c
    codes[..., c:] = codes[..., :pad]  # the pad channels take codes of real channels
    return codes


def _sum_dropping_a_partial(partials):
    return tint8.split_k_sum_plain(partials[:-1])


# sites with pad channels and two or more 128-deep stages of K
@pytest.mark.parametrize('case', [c for c in SITES if c[0] in (
    'resnet50 stem 7x7 s2', 'K, N off the multiples', 'odd shrunk 3x3 s2',
    'resnet50 s2d stem 4x4 on 12 channels')], ids=lambda c: c[0])
def test_planted_layout_faults_fail_the_checks(case):
    x, site = _prepared_site(case)
    assert tint8.pack_weights(site.codes).shape[1] > 128
    assert _layout_gives_plain(x, site, 2)
    assert not _layout_gives_plain(x, site, 2, codes_fn=_pad_coded_from_x)
    assert not _layout_gives_plain(x, site, 2, sum_fn=_sum_dropping_a_partial)


def test_prepared_policy_makes_no_host_tensors_in_a_forward(monkeypatch):
    from pocketflow_tpu_torch.nets.mobilenet import MobileNetV1
    model = MobileNetV1(10, 0.25, dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.eval()
    images = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 32, 32, 3))
                              .astype(np.float32))
    weight_q = tint8.quantize_model_weights(model)
    policy = tint8.Int8ServingPolicy(weight_q, tint8.calibrate(model, [images]))
    with torch.no_grad(), tl.compression(policy):
        first = model(images)
    # the stem, 13 pointwise convs and the dense layer; the depthwise sites skipped
    assert len(policy.sites) == 15
    for site in policy.sites.values():
        for t in (site.codes, site.x_scale, site.scale):
            assert t.device == images.device
        assert site.x_scale.dtype == site.scale.dtype == torch.float32
    made = []

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            made.append(name)
            return fn(*args, **kwargs)
        return wrapped

    for name in ('as_tensor', 'tensor', 'scalar_tensor', 'full', 'zeros', 'ones'):
        monkeypatch.setattr(torch, name, counted(name, getattr(torch, name)))
    monkeypatch.setattr(tint8, 'make_site', counted('make_site', tint8.make_site))
    monkeypatch.setattr(torch.Tensor, 'copy_', counted('copy_', torch.Tensor.copy_))
    tint8.reset_counters()
    with torch.no_grad(), tl.compression(policy):
        second = model(images)
    assert made == []
    assert torch.equal(first, second)
    assert tint8.counters()['plain'] == 15


def test_kernel_wrapper_refuses_inputs_it_does_not_take():
    codes, w_scale = tint8.quantize_weights_symmetric(torch.randn(3, 3, 8, 16))
    site = tint8.make_site(codes, w_scale, 0.05, 'cpu', (1, 1), 'SAME', torch.bfloat16)
    x = torch.randn(2, 8, 6, 6).to(memory_format=torch.channels_last)
    assert tint8.int8_conv(x.to(torch.bfloat16), site).shape == (2, 16, 6, 6)
    with pytest.raises(ValueError, match='bf16 or fp32'):
        tint8.int8_conv(x.half(), site)
    with pytest.raises(ValueError, match='channels-last'):
        tint8.int8_conv(x.contiguous(), site)  # NCHW memory
    with pytest.raises(ValueError, match='channels-last'):
        tint8.int8_conv(torch.randn(2, 4, 6, 6).to(memory_format=torch.channels_last), site)
    with pytest.raises(ValueError, match='no kernel for device'):
        tint8.int8_conv(torch.empty((2, 8, 6, 6), device='meta'), site)
    with pytest.raises(ValueError, match='does not fit'):
        valid = tint8.make_site(codes, w_scale, 0.05, 'cpu', (1, 1), 'VALID')
        tint8.int8_conv(torch.randn(1, 8, 2, 2).to(memory_format=torch.channels_last), valid)
    dense = tint8.make_site(*tint8.quantize_weights_symmetric(torch.randn(40, 12)), 0.1, 'cpu')
    assert tint8.int8_conv(torch.randn(5, 40), dense).shape == (5, 12)
    with pytest.raises(ValueError, match='contiguous'):
        tint8.int8_conv(torch.randn(40, 5).t(), dense)


def _trace():
    """A Chrome trace of one int8 forward: site 'a' on the kernel, launched
    by the site itself, then an op of its own; a BN outside any site; a
    depthwise site on the float path; site 'b' on the kernel alone, and a
    host-to-device copy and a stream sync outside the sites.  The int8
    sites' program spans (``pf.int8.site``) open inside the profile's site
    ranges, as Int8ServingPolicy opens them."""
    from pocketflow_tpu_torch.experiments.int8_serving_profile import SITE
    events, corr = [], [0]

    def op(name, ts, dur, cat='cpu_op'):
        events.append({'cat': cat, 'name': name, 'ts': ts, 'dur': dur, 'tid': 1})

    def launch(ts, dur_us, kernel='k', cat='kernel', runtime='cudaLaunchKernel'):
        corr[0] += 1
        events.append({'cat': 'cuda_runtime', 'name': runtime, 'ts': ts, 'dur': 1,
                       'args': {'correlation': corr[0]}})
        if dur_us:
            events.append({'cat': cat, 'name': kernel, 'ts': 1000 + ts, 'dur': dur_us,
                           'args': {'correlation': corr[0]}})

    op(SITE + 'a', 100, 100, 'user_annotation')
    op('pf.int8.site a', 101, 98, 'user_annotation')
    launch(102, 40, 'void int8_conv_wgmma<128>')
    op('aten::add', 110, 5)
    op('aten::add_', 111, 3)  # a nested op: the part is the top-level one's
    launch(112, 9)
    op('aten::batch_norm', 210, 10)
    launch(212, 20)
    op(SITE + 'dw', 230, 20, 'user_annotation')
    op('aten::conv2d', 232, 10)
    launch(235, 30)
    op(SITE + 'b', 300, 20, 'user_annotation')
    op('pf.int8.site b', 301, 18, 'user_annotation')
    launch(305, 50, 'void int8_conv_wgmma<64>')
    op('aten::to', 330, 5)
    launch(331, 1, 'Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 'cudaMemcpyAsync')
    launch(333, 0, runtime='cudaStreamSynchronize')
    return events


def test_profile_splits_an_int8_forward_by_part():
    from pocketflow_tpu_torch.experiments.int8_serving_profile import trace_parts
    out = trace_parts(_trace(), 1, int8_forward=True)
    assert out['device_ms_by_part'] == pytest.approx({
        'int8 kernel': (40 + 50) / 1e3, 'other site ops': 9 / 1e3,
        'float layers': (20 + 30 + 1) / 1e3})
    assert out['launches_by_part'] == {'int8 kernel': 2, 'other site ops': 1, 'float layers': 3}
    assert out['htod_copies'] == 1 and out['stream_syncs'] == 1
    # the bf16 forward: a site in float is a conv
    bf16 = trace_parts(_trace(), 1, int8_forward=False)
    assert bf16['device_ms_by_part']['convs and dense'] == pytest.approx(30 / 1e3)
    assert bf16['device_ms_by_part']['float layers'] == pytest.approx(20 / 1e3 + 1 / 1e3)
    assert 0.0 < out['idle_share'] < 1.0


@pytest.mark.parametrize('net', ['resnet50', 'mobilenet_v1'])
def test_net_forward_equals_the_contract_route(net):
    """Every int8 site of the serving nets at full width (batch 2, 64x64,
    bf16): the logits through the prepared sites equal the route before the
    kernel's (int8_contract, then each layer's cast), bit for bit."""
    from pocketflow_tpu_torch.nets.mobilenet import MobileNetV1
    from pocketflow_tpu_torch.nets.resnet import ResNetImageNet
    model = (ResNetImageNet(resnet_size=50, nb_classes=1000, dtype=torch.bfloat16)
             if net == 'resnet50' else MobileNetV1(nb_classes=1000, dtype=torch.bfloat16))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.eval()
    images = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 64, 64, 3))
                              .astype(np.float32))
    weight_q = tint8.quantize_model_weights(model)
    scales = tint8.calibrate(model, [images])
    policy = tint8.Int8ServingPolicy(weight_q, scales)
    with torch.no_grad():
        with tl.compression(policy):
            got = model(images)
        # the same sites in int8 (the depthwise ones stay in float)
        int8_paths = {path for path, _ in policy.sites}
        with tl.compression(_ContractPolicy(weight_q, {p: scales[p] for p in int8_paths})):
            want = model(images)
    assert len(int8_paths) == {'resnet50': 54, 'mobilenet_v1': 15}[net]
    assert torch.equal(got, want)
