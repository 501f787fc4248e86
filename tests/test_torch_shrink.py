"""The port's residual-aware channel shrink (pocketflow_tpu_torch/tools/
shrink_graph.py) and width-mapped nets against the JAX package's on the CPU,
in fp32, parameters bridged from the JAX nets' init:

* the captured conv graph (sites in call order with their producers,
  cleanliness, kernel input axis and depthwise flag; protected producers;
  depthwise kernels) equal to JAX's jaxpr capture on ResNet-20, MobileNet-v1
  and v2 (depth 0.25), ConvNet and the space-to-depth ResNet-18 stem;
* ``shrink_residual_aware``'s packed arrays and manifest equal to JAX's on
  the channel-zeroed parameters of tests/test_shrink_residual.py (every
  consumer agrees on the dead input channels);
* ``expand_to_dense`` exact: the scattered-back tree gives bit-equal logits;
* the width-mapped port nets serving the shrunk tree: within 1e-5 (rtol and
  atol) of the dense logits and of the JAX width-mapped net's, physically
  smaller; MobileNet-v2 keeps its residual adds across a shrunk trunk;
* a component every consumer of which reads no channel (a pruner left
  block13/pw of MobileNet-v1 no input channel) keeps its first channel: the
  scatter-back stays exact and the width-mapped net serves it (the JAX
  package slices it to width 0);
* int8 serving of the shrunk ResNet-20 (widths 14 and 62: padded for the
  card's int8 GEMM) with JAX's codes and scales against JAX's, within 1e-3
  of the largest logit (BN runs as other fp32 operations in the two
  packages, so an activation may round to the neighbouring int8 code).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.tools import shrink_graph as jsg
from pocketflow_tpu_torch.core.bridge import load_jax_numpy, to_jax_numpy
from pocketflow_tpu_torch.tools import shrink_graph as tsg
from tests.test_shrink_residual import _zero_in_channels

torch.set_num_threads(2)


def _nets(name):
    """(JAX net, port net class, its kwargs, NHWC sample shape)."""
    from pocketflow_tpu.nets import convnet_at_fmnist as jc, mobilenet as jmb, resnet as jr
    from pocketflow_tpu_torch.nets import convnet_at_fmnist as tc, mobilenet as tmb, resnet as tr
    f32, t32 = jnp.float32, torch.float32
    return {
        'resnet20': (jr.ResNetCifar(nb_blocks=3, nb_classes=10, dtype=f32), tr.ResNetCifar,
                     dict(nb_blocks=3, nb_classes=10, dtype=t32), (2, 32, 32, 3)),
        'mobilenet_v1': (jmb.MobileNetV1(nb_classes=10, depth_mult=0.25, dtype=f32),
                         tmb.MobileNetV1, dict(nb_classes=10, depth_mult=0.25, dtype=t32),
                         (2, 32, 32, 3)),
        'mobilenet_v2': (jmb.MobileNetV2(nb_classes=10, depth_mult=0.25, dtype=f32),
                         tmb.MobileNetV2, dict(nb_classes=10, depth_mult=0.25, dtype=t32),
                         (2, 32, 32, 3)),
        'convnet': (jc.ConvNet(nb_classes=10, dtype=f32), tc.ConvNet,
                    dict(nb_classes=10, dtype=t32), (2, 28, 28, 1)),
        'resnet18_s2d': (jr.ResNetImageNet(resnet_size=18, nb_classes=10, dtype=f32,
                                           stem_space_to_depth=True), tr.ResNetImageNet,
                         dict(resnet_size=18, nb_classes=10, dtype=t32,
                              stem_space_to_depth=True), (2, 64, 64, 3)),
    }[name]


def _setup(name, zero=None, seed=0):
    """(JAX net, numpy params, batch_stats, port net loaded with them, port
    class and kwargs, NHWC images).  `zero` input channels are zeroed in
    every consumer; BN statistics are moved off their init."""
    jm, cls, kwargs, shape = _nets(name)
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    variables = jax.device_get(jax.jit(lambda: jm.init(jax.random.PRNGKey(seed),
                                                       jnp.asarray(x), train=False))())
    params = jax.tree_util.tree_map(np.array, variables['params'])
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape) if p[-1].key == 'mean'
                      else np.asarray(v) * (1 + 0.2 * rng.random(v.shape))).astype(np.float32),
        variables.get('batch_stats', {}))
    if zero is not None:
        params = _zero_in_channels(params, zero)
    tm = cls(**kwargs)
    load_jax_numpy(tm, params, stats)
    return jm, params, stats, tm.eval(), cls, kwargs, x


def _sites(graph):
    return [(s.consumer, s.producers, s.clean, s.in_dim, s.depthwise) for s in graph.sites]


@pytest.mark.parametrize('name', ['resnet20', 'mobilenet_v1', 'mobilenet_v2', 'convnet',
                                  'resnet18_s2d'])
def test_captured_graph_equals_jax(name):
    jm, params, stats, tm, _, _, x = _setup(name)
    want = jsg.capture_conv_graph(jm, {'params': params, 'batch_stats': stats}, x.shape)
    got = tsg.capture_conv_graph(tm, x.shape)
    assert _sites(got) == _sites(want)
    assert got.protected == want.protected and got.depthwise == want.depthwise
    if name == 'resnet20':  # a residual merge: the identity shortcut carries conv_init
        site = next(s for s in got.sites if s.consumer == 'stage1_block1/conv1')
        assert site.clean and {'stage1_block0/conv2', 'conv_init'} <= site.producers
    if name == 'resnet18_s2d':  # the space-to-depth stem reads no producer
        assert got.sites[0].consumer == 'conv_init' and not got.sites[0].clean


def _logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize('name,zero', [('resnet20', [0, 1]), ('mobilenet_v1', [0]),
                                       ('resnet18_s2d', [0, 1, 2])])
def test_shrink_equals_jax_and_scatters_back_exactly(name, zero):
    jm, params, stats, tm, _, _, x = _setup(name, zero)
    graph = tsg.capture_conv_graph(tm, x.shape)
    tparams, tstats = to_jax_numpy(tm)
    packed, manifest = tsg.shrink_residual_aware(tparams, tstats, graph)
    jgraph = jsg.capture_conv_graph(jm, {'params': params, 'batch_stats': stats}, x.shape)
    jpacked, jmanifest = jsg.shrink_residual_aware(params, stats, jgraph)
    assert manifest['components'] and json.dumps(manifest, sort_keys=True) == json.dumps(
        jmanifest, sort_keys=True)
    assert list(packed) == list(jpacked)
    for key in packed:
        np.testing.assert_array_equal(packed[key], jpacked[key], err_msg=key)
    # the inputs were not modified
    for key, leaf in tsg.tree_leaves(tparams):
        assert leaf.shape == tuple(np.shape(_get(params, key))), key
    dense_p, dense_s = tsg.expand_to_dense(packed, manifest, tparams, tstats)
    dense = load_jax_numpy(tm.clone(), dense_p, dense_s).eval()
    np.testing.assert_array_equal(_logits(dense, x), _logits(tm, x))


def _get(tree, path):
    for part in path.split('/'):
        tree = tree[part]
    return tree


@pytest.mark.parametrize('name,zero', [('resnet20', [0, 1, 2, 3]), ('mobilenet_v1', [0, 1]),
                                       ('mobilenet_v2', [0, 1])])
def test_width_mapped_net_serves_the_shrunk_tree(name, zero):
    jm, params, stats, tm, cls, kwargs, x = _setup(name, zero, seed=3)
    graph = tsg.capture_conv_graph(tm, x.shape)
    packed, manifest = tsg.shrink_residual_aware(*to_jax_numpy(tm), graph)
    wm = tsg.width_map_from_packed(packed, manifest)
    small = tm.clone(width_map=wm)
    assert type(small) is cls and small.config == {**kwargs, 'width_map': wm}
    variables = tsg.variables_from_packed(packed)
    load_jax_numpy(small, variables['params'], variables['batch_stats'])
    ref = _logits(tm, x)
    got = _logits(small.eval(), x)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    nb_small = sum(p.numel() for p in small.parameters())
    assert nb_small < sum(p.numel() for p in tm.parameters())
    if name == 'resnet20':
        assert wm['stage1_block0/conv1'] == 12  # 16 - 4 physically gone
        assert small.fc.kernel.shape[0] == 60
    if name == 'mobilenet_v2':
        # the shrunk trunks keep their residual adds, as the dense net
        assert [m.residual for m in small.modules() if hasattr(m, 'residual')] == \
            [m.residual for m in tm.modules() if hasattr(m, 'residual')]
        assert any(len(c['producers']) > 1 for c in manifest['components'])
    if name != 'mobilenet_v2':  # the JAX net keys its v2 residual by the dense width
        jsmall = jm.clone(width_map=wm)
        want = np.asarray(jsmall.apply(variables, jnp.asarray(x), train=False))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_int8_serving_of_the_shrunk_net_matches_jax():
    from pocketflow_tpu.nn.layers import compression as jcompression
    from pocketflow_tpu.ops import int8_ops as jint8
    from pocketflow_tpu_torch.nn.layers import compression
    from pocketflow_tpu_torch.ops import int8_ops as tint8
    jm, params, stats, tm, _, _, x = _setup('resnet20', [0, 1], seed=5)
    x = x * 0.5
    packed, manifest = tsg.shrink_residual_aware(*to_jax_numpy(tm),
                                                 tsg.capture_conv_graph(tm, x.shape))
    wm = tsg.width_map_from_packed(packed, manifest)
    assert wm['conv_init'] == 14 and packed['fc/kernel'].shape[0] == 62
    variables = tsg.variables_from_packed(packed)
    small = tm.clone(width_map=wm)
    load_jax_numpy(small, variables['params'], variables['batch_stats'])
    jsmall = jm.clone(width_map=wm)
    scales = jint8.calibrate(jsmall, variables, [jnp.asarray(x)])
    weight_q = jint8.quantize_model_weights(variables['params'])
    with jcompression(jint8.Int8ServingPolicy(weight_q, scales)):
        want = np.asarray(jsmall.apply(variables, jnp.asarray(x), train=False))
    tq = {path: (torch.from_numpy(np.array(c)), torch.from_numpy(np.array(s)))
          for path, (c, s) in weight_q.items()}
    with compression(tint8.Int8ServingPolicy(tq, scales)):
        got = _logits(small.eval(), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * float(np.abs(want).max()))


def test_a_fully_dead_component_keeps_one_channel():
    _, params, stats, tm, _, _, x = _setup('mobilenet_v1', [0], seed=4)
    with torch.no_grad():
        tm.block13.pw.kernel.zero_()  # no input channel left to block13/pw
    graph = tsg.capture_conv_graph(tm, x.shape)
    tparams, tstats = to_jax_numpy(tm)
    packed, manifest = tsg.shrink_residual_aware(tparams, tstats, graph)
    comp = next(c for c in manifest['components'] if c['producers'] == ['block12/pw'])
    assert comp['kept_channels'] == [0] and comp['orig_channels'] == 256
    assert packed['block13/dw/kernel'].shape == (3, 3, 1, 1)
    dense_p, dense_s = tsg.expand_to_dense(packed, manifest, tparams, tstats)
    dense = load_jax_numpy(tm.clone(), dense_p, dense_s).eval()
    np.testing.assert_array_equal(_logits(dense, x), _logits(tm, x))
    small = tm.clone(width_map=tsg.width_map_from_packed(packed, manifest))
    variables = tsg.variables_from_packed(packed)
    load_jax_numpy(small, variables['params'], variables['batch_stats'])
    np.testing.assert_allclose(_logits(small.eval(), x), _logits(tm, x), rtol=1e-5, atol=1e-5)
