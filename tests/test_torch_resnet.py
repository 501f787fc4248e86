"""Parity of the port's layers, ResNet blocks, loss pieces, schedules and
augment ops with the JAX package, in fp32 on the CPU.  Parameters go through
the bridge (core/bridge.py); inputs are made with numpy from a seed.
Layer tolerance: atol=rtol=1e-4 (fp32, different conv and reduction orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.core import mesh as mesh_lib
from pocketflow_tpu.nn import layers as jl
from pocketflow_tpu.nets import resnet as jr
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core.bridge import load_jax_numpy
from pocketflow_tpu_torch.nn import layers as tl
from pocketflow_tpu_torch.nets import resnet as tr

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _port_flags():
    """The port's own registry, scoped per test (conftest scopes the JAX one),
    and a one-device JAX mesh so ghost-BN sees one data shard on both sides."""
    mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:1], ('data',), (1,)))
    with TFLAGS.scope(bn_stats_subsample=1, compute_dtype='float32'):
        yield


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _randomized(variables, seed):
    """Perturb Flax variables away from their init (BN scale 1 / bias 0)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        jax.device_get(variables))


@pytest.mark.parametrize('kernel,stride,size', [
    (3, 2, 8),    # stride-2 3x3 conv2 of a bottleneck: pads (0, 1)
    (4, 1, 16),   # 4x4/s1 space-to-depth stem: pads (1, 2)
    (7, 2, 32),   # 7x7/s2 stem: pads (2, 3)
    (3, 1, 9),    # symmetric 3x3
    (1, 2, 8),    # strided 1x1 shortcut: no padding
])
def test_pfconv_same_padding_matches_flax(kernel, stride, size):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, size, size, 5)).astype(np.float32)
    jconv = jl.PFConv(6, (kernel, kernel), (stride, stride), use_bias=True, dtype=jnp.float32)
    variables = _randomized(jconv.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    tconv = tl.PFConv(5, 6, (kernel, kernel), (stride, stride), use_bias=True, dtype=torch.float32)
    load_jax_numpy(tconv, variables['params'], {})
    assert tuple(tconv.kernel.shape) == (kernel, kernel, 5, 6)  # HWIO kept
    got = _nhwc(tconv(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_same_max_pool_matches_flax():
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 4)).astype(np.float32) - 3.0
    want = np.asarray(jl.max_pool(jnp.asarray(x), (3, 3), (2, 2), padding='SAME'))
    got = _nhwc(tl.max_pool(_nchw(x), (3, 3), (2, 2), padding='SAME'))
    np.testing.assert_array_equal(got, want)


def test_pfdense_matches_flax():
    x = np.random.default_rng(2).normal(size=(3, 7)).astype(np.float32)
    jd = jl.PFDense(5, dtype=jnp.float32)
    variables = _randomized(jd.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    td = tl.PFDense(7, 5, dtype=torch.float32)
    load_jax_numpy(td, variables['params'], {})
    np.testing.assert_allclose(td(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jd.apply(variables, jnp.asarray(x))), **TOL)


def _bn_pair(seed, features=6):
    x = (np.random.default_rng(seed).normal(size=(8, 5, 5, features)) * 2 + 0.5).astype(np.float32)
    jbn = jl.BatchNorm(dtype=jnp.float32)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=True)
    variables = _randomized(variables, seed + 1)
    variables['batch_stats']['bn']['var'] = np.abs(variables['batch_stats']['bn']['var'])
    tbn = tl.BatchNorm(features, dtype=torch.float32)
    load_jax_numpy(tbn, variables['params'], variables['batch_stats'])
    return x, jbn, variables, tbn


@pytest.mark.parametrize('subsample', [1, 2])
def test_batchnorm_train_output_and_running_stats(subsample):
    """Exact BN (Flax nn.BatchNorm) and ghost-BN (_GhostBatchNorm, stats from
    the leading 1/S of the batch): output, and the running statistics moved
    with momentum 0.997 and the biased batch variance."""
    x, jbn, variables, tbn = _bn_pair(4)
    with JFLAGS.scope(bn_stats_subsample=subsample), TFLAGS.scope(bn_stats_subsample=subsample):
        want, new_vars = jbn.apply(variables, jnp.asarray(x), use_running_average=False,
                                   mutable=['batch_stats'])
        tbn.train()
        got = tbn(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    for key in ('mean', 'var'):
        np.testing.assert_allclose(getattr(tbn.bn, key).numpy(),
                                   np.asarray(new_vars['batch_stats']['bn'][key]), **TOL)


def test_batchnorm_eval_uses_running_stats():
    x, jbn, variables, tbn = _bn_pair(5)
    want = jbn.apply(variables, jnp.asarray(x), use_running_average=True)
    tbn.eval()
    before = tbn.bn.mean.clone()
    got = tbn(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    assert torch.equal(tbn.bn.mean, before)


@pytest.mark.parametrize('block,strides,cin,features', [
    ('bottleneck', (2, 2), 16, 4), ('bottleneck', (1, 1), 16, 4), ('bottleneck', (1, 1), 8, 4),
    ('basic', (2, 2), 8, 16)])
def test_block_train_forward_and_grads_match_flax(block, strides, cin, features):
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(4, 8, 8, cin)) * 2 + 0.3).astype(np.float32)
    jcls, tcls = ((jr.BottleneckBlock, tr.BottleneckBlock) if block == 'bottleneck'
                  else (jr.BasicBlock, tr.BasicBlock))
    jblk = jcls(features=features, strides=strides, dtype=jnp.float32)
    variables = jblk.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    variables = {'params': _randomized(variables['params'], 7),
                 'batch_stats': jax.device_get(variables['batch_stats'])}
    out_shape = jax.eval_shape(lambda v: jblk.apply(v, jnp.asarray(x), train=False), variables)
    g = rng.normal(size=out_shape.shape).astype(np.float32)

    def loss(params, xx):
        y, st = jblk.apply({'params': params, 'batch_stats': variables['batch_stats']}, xx,
                           train=True, mutable=['batch_stats'])
        return jnp.sum(y * g), (y, st)

    (_, (jy, jst)), (jgp, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables['params'], jnp.asarray(x))
    tblk = tcls(cin, features, strides, torch.float32)
    load_jax_numpy(tblk, variables['params'], variables['batch_stats'])
    tblk.train()
    xt = _nchw(x).requires_grad_(True)
    ty = tblk(xt)
    (ty * _nchw(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jgx), **TOL)
    flat_grads = dict(jax.tree_util.tree_flatten_with_path(jgp)[0])
    for path, value in flat_grads.items():
        name = '.'.join(p.key for p in path)
        np.testing.assert_allclose(dict(tblk.named_parameters())[name].grad.numpy(),
                                   np.asarray(value), **TOL, err_msg=name)
    stats = dict(jax.tree_util.tree_flatten_with_path(jst['batch_stats'])[0])
    for path, value in stats.items():
        name = '.'.join(p.key for p in path)
        np.testing.assert_allclose(dict(tblk.named_buffers())[name].numpy(), np.asarray(value),
                                   **TOL, err_msg=name)


def test_space_to_depth_matches_jax():
    x = np.random.default_rng(8).normal(size=(2, 8, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(tr.space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jr.space_to_depth(jnp.asarray(x))))


@pytest.mark.parametrize('size,s2d', [(18, False), (50, False), (50, True)])
def test_resnet_imagenet_eval_logits_match_flax(size, s2d):
    x = np.random.default_rng(9).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = jr.ResNetImageNet(resnet_size=size, nb_classes=11, dtype=jnp.float32,
                           stem_space_to_depth=s2d)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), train=False)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    tm = tr.ResNetImageNet(size, 11, torch.float32, s2d)
    load_jax_numpy(tm, jax.device_get(variables['params']),
                   jax.device_get(variables['batch_stats']))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_loss_pieces_match_jax():
    from pocketflow_tpu.nets.abstract_model_helper import AbstractModelHelper as JH
    from pocketflow_tpu_torch.nets.abstract_model_helper import AbstractModelHelper as TH
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(16, 20)).astype(np.float32)
    labels = rng.integers(0, 20, size=16).astype(np.int32)
    jlog, jlab = jnp.asarray(logits), jnp.asarray(labels)
    tlog, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(float(TH.softmax_cross_entropy(tlab, tlog)),
                               float(JH.softmax_cross_entropy(jlab, jlog)), rtol=1e-6)
    for k in (1, 5):
        assert float(TH.accuracy(tlab, tlog, k)) == float(JH.accuracy(jlab, jlog, k))
    params = {'conv/kernel': rng.normal(size=(3, 3, 2, 4)), 'bn1/bn/scale': rng.normal(size=4),
              'fc/kernel': rng.normal(size=(4, 3)), 'fc/bias': rng.normal(size=3),
              'stage1_block0/bn_sc/bn/bias': rng.normal(size=4)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    nested = {}
    for path, value in params.items():
        node = nested
        for key in path.split('/')[:-1]:
            node = node.setdefault(key, {})
        node[path.split('/')[-1]] = jnp.asarray(value)
    want = float(JH.weight_decay_loss(nested, coeff=1.0))
    got = float(TH.weight_decay_loss(((k, torch.from_numpy(v)) for k, v in params.items()),
                                     coeff=1.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize('kind', ['piecewise', 'exponential'])
def test_schedules_match_jax_step_for_step(kind):
    from pocketflow_tpu.core import schedules as js
    from pocketflow_tpu_torch.core import schedules as ts
    flags = dict(lrn_rate_init=0.3, batch_size_norm=64, nb_epochs_rat=0.5)
    with JFLAGS.scope(**flags), TFLAGS.scope(**flags):
        if kind == 'piecewise':
            args = (32, [1, 2, 3], [1.0, 0.1, 0.01, 0.001], 320)
            jsch, tsch = js.piecewise_constant(*args), ts.piecewise_constant(*args)
        else:
            args = (32, 1.5, 0.5, 320)
            jsch, tsch = js.exponential_decay(*args), ts.exponential_decay(*args)
        for step in range(0, 40):
            assert tsch(step) == float(jsch(jnp.asarray(step))), step


def test_augment_ops_match_jax():
    from pocketflow_tpu.datasets import augment as ja
    from pocketflow_tpu_torch.datasets import augment as ta
    imgs = np.random.default_rng(11).integers(0, 256, size=(3, 20, 24, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        ta.center_crop_resize(torch.from_numpy(imgs), (16, 16)).numpy(),
        np.asarray(ja.center_crop_resize(jnp.asarray(imgs), (16, 16))))
    mean, std = (120.0, 110.0, 100.0), (50.0, 60.0, 70.0)
    np.testing.assert_allclose(ta.normalize(torch.from_numpy(imgs), mean, std).numpy(),
                               np.asarray(ja.normalize(jnp.asarray(imgs), mean, std)),
                               rtol=1e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    flipped = ta.random_flip_lr(torch.from_numpy(imgs), gen).numpy()
    for i in range(3):  # each sample is itself or its mirror image
        assert (np.array_equal(flipped[i], imgs[i])
                or np.array_equal(flipped[i], imgs[i, :, ::-1]))
    crops = ta.random_crop_resize(torch.from_numpy(imgs), gen, (16, 16))
    assert crops.shape == (3, 16, 16, 3) and crops.dtype == torch.uint8
