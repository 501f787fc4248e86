"""The port's model zoo against the JAX nets on the CPU: ConvNet @ FMNIST,
LeNet @ CIFAR-10 and ResNet-20 @ CIFAR-10, in fp32, parameters carried
across by the bridge (biases and BN variables moved off their init).

* eval logits in fp32: rtol=atol=1e-4;
* under the 4-bit QuantPolicy: every quantized weight bit-equal to the JAX
  policy's, logits within 1e-3; with 8-bit activations, each activation
  site bit-equal to the JAX policy's on the same input;
* quant sites: the same weight paths and shapes, and the counts the chip
  smoke asserts (ResNet-20: 22 weights, 20 quantized, 19 activation sites;
  ConvNet and LeNet: 4 weights, 2 quantized, 3 activation sites);
* fc3's rows follow the JAX package's H, W, C flatten: the C, H, W order of a
  plain reshape gives other logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.learners.uniform_quantization import utils as juq
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core.bridge import load_jax_numpy
from pocketflow_tpu_torch.learners.uniform_quantization import utils as tuq
from pocketflow_tpu_torch.nn import layers as tl

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)

# model -> (input shape NHWC, (quantized weights, activation sites))
NETS = {
    'convnet_at_fmnist': ((2, 28, 28, 1), (2, 3)),
    'lenet_at_cifar10': ((2, 32, 32, 3), (2, 3)),
    'resnet_at_cifar10': ((2, 32, 32, 3), (20, 19)),
}


def _nets(model):
    if model == 'convnet_at_fmnist':
        from pocketflow_tpu.nets.convnet_at_fmnist import ConvNet as J
        from pocketflow_tpu_torch.nets.convnet_at_fmnist import ConvNet as T
        return J(dtype=jnp.float32), T(dtype=torch.float32)
    if model == 'lenet_at_cifar10':
        from pocketflow_tpu.nets.lenet_at_cifar10 import LeNet as J
        from pocketflow_tpu_torch.nets.lenet_at_cifar10 import LeNet as T
        return J(dtype=jnp.float32), T(dtype=torch.float32)
    from pocketflow_tpu.nets.resnet import ResNetCifar as J
    from pocketflow_tpu_torch.nets.resnet import ResNetCifar as T
    return J(nb_blocks=3, dtype=jnp.float32), T(nb_blocks=3, dtype=torch.float32)


def _setup(model, seed=0):
    """(JAX module, variables, port module loaded with them, images)."""
    shape, _ = NETS[model]
    x = (np.random.default_rng(seed).normal(size=shape) * 1.5).astype(np.float32)
    jm, tm = _nets(model)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False))
    rng = np.random.default_rng(seed + 1)

    def moved(path, leaf):  # biases, BN scales and statistics off their init
        leaf = np.asarray(leaf)
        if path[-1].key in ('bias', 'scale', 'mean'):
            return leaf + 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == 'var':
            return leaf * (1 + 0.2 * rng.random(leaf.shape)).astype(np.float32)
        return leaf

    variables = jax.tree_util.tree_map_with_path(moved, variables)
    load_jax_numpy(tm, variables['params'], variables.get('batch_stats', {}))
    tm.eval()
    return jm, variables, tm, x


def _sites(model, jm, variables, tm, x):
    jsites = juq.discover_quant_sites(jm, variables, jnp.asarray(x))
    tsites = tuq.discover_quant_sites(tm, torch.from_numpy(x))
    return jsites, tsites


@pytest.mark.parametrize('model', sorted(NETS))
def test_fp32_eval_logits_match_jax(model):
    jm, variables, tm, x = _setup(model)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (x.shape[0], 10)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('model', sorted(NETS))
def test_quant_sites_match_jax(model):
    jm, variables, tm, x = _setup(model)
    jsites, tsites = _sites(model, jm, variables, tm, x)
    assert tsites['weight_paths'] == jsites['weight_paths']
    assert tsites['weight_shapes'] == [tuple(s) for s in jsites['weight_shapes']]
    assert (tsites['nb_matmuls'], tsites['nb_activations']) == NETS[model][1]
    assert jsites['nb_activations'] == NETS[model][1][1]
    with TFLAGS.scope(uql_quantize_all_layers=True):
        assert tuq.discover_quant_sites(tm, torch.from_numpy(x))['nb_matmuls'] == \
            NETS[model][1][0] + 2


@pytest.mark.parametrize('model', sorted(NETS))
def test_quantized_eval_matches_jax(model):
    """4-bit weights: each quantized kernel bit-equal to the JAX policy's;
    logits within 1e-3."""
    jm, variables, tm, x = _setup(model)
    jsites, tsites = _sites(model, jm, variables, tm, x)
    paths = jsites['weight_paths']
    flags = dict(uql_activation_bits=32, uql_use_buckets=False)
    with JFLAGS.scope(**flags), TFLAGS.scope(**flags):
        w_bits = np.full(len(paths), 4.0, np.float32)
        a_bits = np.full(jsites['nb_activations'], 32.0, np.float32)
        jpolicy = juq.QuantPolicy(paths, jnp.asarray(w_bits), jnp.asarray(a_bits))
        tpolicy = tuq.QuantPolicy(paths, torch.from_numpy(w_bits), torch.from_numpy(a_bits),
                                  tuq.quant_weights(tm, paths))
        kernels = {m.path: m.kernel for m in tm.modules()
                   if isinstance(m, (tl.PFConv, tl.PFDense))}
        flat = {'/'.join(k.key for k in path[:-1]): leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(variables['params'])[0]
                if path[-1].key == 'kernel'}
        tpolicy.reset_trace()
        for path in paths:
            want = np.asarray(jpolicy.process_weight(path, jnp.asarray(flat[path])))
            got = tpolicy.process_weight(path, kernels[path]).detach().numpy()
            np.testing.assert_array_equal(got, want, err_msg=path)
        want = np.asarray(jax.jit(lambda v, xx: _apply_with(jm, v, xx, paths, w_bits, a_bits))(
            variables, jnp.asarray(x)))
        with torch.no_grad(), tl.compression(tpolicy):
            got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize('model', sorted(NETS))
def test_8bit_activation_sites_quantize_as_jax(model):
    """--uql_activation_bits=8: each activation site of the port's eval
    forward returns, bit for bit, what the JAX QuantPolicy.process_act
    returns on the same input (the logits are not compared: an 8-bit level
    a rounding away from its edge flips between the two frameworks' sum
    orders, as in tests/test_torch_qat_slice_act8.py)."""
    jm, variables, tm, x = _setup(model)
    jsites, _ = _sites(model, jm, variables, tm, x)
    paths = jsites['weight_paths']
    flags = dict(uql_activation_bits=8, uql_use_buckets=False)
    with JFLAGS.scope(**flags), TFLAGS.scope(**flags):
        w_bits = np.full(len(paths), 4.0, np.float32)
        a_bits = np.full(jsites['nb_activations'], 8.0, np.float32)
        jpolicy = juq.QuantPolicy(paths, jnp.asarray(w_bits), jnp.asarray(a_bits))
        tpolicy = tuq.QuantPolicy(paths, torch.from_numpy(w_bits), torch.from_numpy(a_bits),
                                  tuq.quant_weights(tm, paths))
        sites, quantize = [], tpolicy.process_act

        def recording(path, act):
            out = quantize(path, act)
            if path.startswith('act/'):
                sites.append((path, act.numpy().copy(), out.numpy().copy()))
            return out

        tpolicy.process_act = recording
        with torch.no_grad(), tl.compression(tpolicy):
            tm(torch.from_numpy(x))
        assert [p for p, _, _ in sites] == ['act/%d' % i for i in range(NETS[model][1][1])]
        for path, act, got in sites:
            nhwc = (lambda a: a.transpose(0, 2, 3, 1) if a.ndim == 4 else a)
            want = np.asarray(jpolicy.process_act(path, jnp.asarray(nhwc(act))))
            np.testing.assert_array_equal(nhwc(got), want, err_msg=path)
            assert not np.array_equal(got, act), path


def _apply_with(jm, variables, x, paths, w_bits, a_bits):
    from pocketflow_tpu.nn.layers import compression
    with compression(juq.QuantPolicy(paths, jnp.asarray(w_bits), jnp.asarray(a_bits))):
        return jm.apply(variables, x, train=False)


@pytest.mark.parametrize('model', ['convnet_at_fmnist', 'lenet_at_cifar10'])
def test_fc3_rows_follow_the_hwc_flatten(model, monkeypatch):
    """A C, H, W flatten feeds fc3 permuted inputs: the logits move far past
    the parity tolerance, so the test above tells the two orders apart."""
    jm, variables, tm, x = _setup(model)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    module = __import__('pocketflow_tpu_torch.nets.' + model, fromlist=['flatten_hwc'])
    monkeypatch.setattr(module, 'flatten_hwc', lambda t: t.reshape(t.shape[0], -1))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() > 100 * TOL['atol']


def test_pfconv_valid_padding_matches_flax():
    from pocketflow_tpu.nn import layers as jl
    x = np.random.default_rng(3).normal(size=(2, 12, 10, 3)).astype(np.float32)
    jconv = jl.PFConv(4, (5, 5), padding='VALID', dtype=jnp.float32)
    variables = jax.device_get(jconv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables['params']['bias'] = np.linspace(-1, 1, 4).astype(np.float32)
    want = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    tconv = tl.PFConv(3, 4, (5, 5), padding='VALID', dtype=torch.float32)
    load_jax_numpy(tconv, variables['params'], {})
    got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 8, 6, 4)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match='padding'):
        tl.PFConv(3, 4, padding='FULL')


def test_resnet_size_refusals():
    from pocketflow_tpu_torch.nets import resnet_at_cifar10, resnet_at_ilsvrc12
    with pytest.raises(ValueError, match='6n\\+2'):
        resnet_at_cifar10.ModelHelper(resnet_size=21)
    with TFLAGS.scope(synthetic_data=True, resnet_size=20):
        with pytest.raises(ValueError, match='--resnet_size with one of \\[18, 34, 50'):
            resnet_at_ilsvrc12.ModelHelper()
    # --remat_blocks is no longer refused: ResNet-20 builds under 'full' and
    # trains (a forward, a backward and an SGD update) as under 'none'
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32))
    params = []
    for mode in ('none', 'full'):
        with TFLAGS.scope(remat_blocks=mode):
            net = _nets('resnet_at_cifar10')[1]
        assert {m.remat for m in net.modules() if isinstance(m, tl.RematBlock)} == {mode}
        tl.reset_parameters(net, torch.Generator().manual_seed(0))
        opt = torch.optim.SGD(net.parameters(), lr=0.1)
        (net.train()(x) ** 2).sum().backward()
        opt.step()
        params.append({**dict(net.named_parameters()), **dict(net.named_buffers())})
    assert all(torch.equal(params[1][k], v) for k, v in params[0].items())
