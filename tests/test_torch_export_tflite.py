"""The port's TFLite and SavedModel export (pocketflow_tpu_torch/tools/
{tf_lowering,export_tflite,export_cli}.py) against the live model and the JAX
package's exporter (jax2tf) on the same bridged weights, on the CPU:

* the lowering: every classification net lowers completely at a small
  width, its TF function within fp32 rounding of the torch forward; an op
  outside the table raises, naming the op and the node;
* float TFLite (ConvNet, ResNet-20, MobileNet-v1, ResNet-ILSVRC with the
  space-to-depth stem): within 1e-2 of the live model (the JAX package's
  test_tflite_export.py tolerance) and within 1e-4 + 1e-4 max|logit| of the
  JAX exporter's artifact;
* dynamic and int8 modes (the JAX package's asserts; the int8 top-1
  agreement with the JAX artifact is printed, not asserted), the SavedModel
  within 1e-4 under 'serving_default', the bf16 guard, the latency protocol;
* the QAT deploy fold: the grouped K2' fold bit-equal to per-site
  ``fake_quant_channel_bucket`` and to the plain ``_column_plain``, within
  one fp32 rounding of the per-channel range of JAX's jitted fold; an int8
  artifact that carries hand-capped activation ranges (act_max 0.8) follows
  the QAT forward and not the float one, and agrees with JAX's artifact;
* ``export_cli.main(..., device='cpu')`` in every --tflite_mode, with
  --export_saved_model, --tflite_latency and 'chn-pruned-residual'.

The measured deltas print as 'TFLITE' lines (pytest -s).
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip('tensorflow')

from pocketflow_tpu.config import FLAGS as JFLAGS  # noqa: E402
from pocketflow_tpu.tools import export_tflite as jtfl  # noqa: E402
from pocketflow_tpu_torch.config import FLAGS as TFLAGS  # noqa: E402
from pocketflow_tpu_torch.core.bridge import load_jax_numpy  # noqa: E402
from pocketflow_tpu_torch.tools import export_tflite as ptfl  # noqa: E402
from pocketflow_tpu_torch.tools import tf_lowering  # noqa: E402
from torch_cli_flags import drop_export_cli_flags  # noqa: E402

torch.set_num_threads(2)
LIVE_ATOL = 1e-2      # test_tflite_export.py's float tolerance
SAVED_ATOL = 1e-4     # test_tflite_export.py's SavedModel tolerance
# the port's op-by-op fold against JAX's jitted one: XLA rounds
# alpha*round(.)/k+beta in another order (ROADMAP section 3)
JIT_FOLD_ULPS = 4


def _cross_tol(logits):
    """The port's float artifact against the JAX exporter's."""
    return 1e-4 + 1e-4 * float(np.abs(logits).max())


@contextlib.contextmanager
def _flags_kept(registry, **overrides):
    """Every flag of `registry` as it was before the block (a CLI's parse
    sets flags outside any scope), flags defined inside back at their
    defaults."""
    saved = registry.as_dict()
    with registry.scope(**{**saved, **overrides}):
        yield
    for name, spec in registry._specs.items():
        if name not in saved:
            setattr(registry, name, spec.default)


@pytest.fixture(autouse=True)
def _port_flags():
    """Both registries as they were before the test, and the port's without
    the flags export_cli.main registered in it."""
    with _flags_kept(TFLAGS), _flags_kept(JFLAGS):
        yield
    drop_export_cli_flags(TFLAGS)


def _perturbed_stats(stats, seed=1):
    """BN running statistics moved off their init, so BN is no identity."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape) if p[-1].key == 'mean'
                      else np.asarray(v) * (1 + 0.2 * rng.random(v.shape))).astype(np.float32),
        jax.device_get(stats))


def _build(name):
    """(JAX module, numpy variables, bridged port model in eval mode, images)."""
    from pocketflow_tpu.nets import mobilenet as jmb, resnet as jrs
    from pocketflow_tpu.nets.convnet_at_fmnist import ConvNet as JConvNet
    from pocketflow_tpu_torch.nets import mobilenet as tmb, resnet as trs
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ConvNet
    f32 = torch.float32
    nets = {
        'convnet': (JConvNet(nb_classes=10, dtype=jnp.float32), ConvNet(10, f32), (2, 28, 28, 1)),
        'resnet20': (jrs.ResNetCifar(nb_blocks=3, nb_classes=10, dtype=jnp.float32),
                     trs.ResNetCifar(3, 10, f32), (2, 32, 32, 3)),
        'mobilenet_v1': (jmb.MobileNetV1(nb_classes=10, depth_mult=0.25, dtype=jnp.float32),
                         tmb.MobileNetV1(10, 0.25, f32), (2, 32, 32, 3)),
        'resnet18_s2d': (jrs.ResNetImageNet(resnet_size=18, nb_classes=10, dtype=jnp.float32,
                                            stem_space_to_depth=True),
                         trs.ResNetImageNet(18, 10, f32, stem_space_to_depth=True),
                         (2, 64, 64, 3)),
    }
    jmodel, tmodel, shape = nets[name]
    images = np.random.default_rng(0).random(shape).astype(np.float32)
    variables = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), images, train=False))()
    variables = {'params': jax.tree_util.tree_map(np.array, jax.device_get(variables['params'])),
                 'batch_stats': _perturbed_stats(variables.get('batch_stats', {}))}
    load_jax_numpy(tmodel, variables['params'], variables['batch_stats'])
    return jmodel, variables, tmodel.eval(), images


@pytest.fixture(scope='module')
def zoo():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _build(name)
        return cache[name]
    return get


def _live(model, images):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(np.asarray(images))).numpy()


# ---------------------------------------------------------------------------
# the lowering
# ---------------------------------------------------------------------------

def _port_net(name):
    from pocketflow_tpu_torch.nets import mobilenet as tmb, resnet as trs
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ConvNet
    from pocketflow_tpu_torch.nets.lenet_at_cifar10 import LeNet
    f32 = torch.float32
    return {'ConvNet': (ConvNet(10, f32), (2, 28, 28, 1)),
            'LeNet': (LeNet(10, f32), (2, 32, 32, 3)),
            'ResNet-20': (trs.ResNetCifar(3, 10, f32), (2, 32, 32, 3)),
            'ResNet-18-s2d': (trs.ResNetImageNet(18, 10, f32, stem_space_to_depth=True),
                              (2, 64, 64, 3)),
            'ResNet-50': (trs.ResNetImageNet(50, 10, f32), (2, 64, 64, 3)),
            'MobileNet-v1': (tmb.MobileNetV1(10, 0.25, f32), (2, 64, 64, 3)),
            'MobileNet-v2': (tmb.MobileNetV2(10, 0.35, f32), (2, 64, 64, 3))}[name]


# the ops each net's plan must hold: every 'SAME' pad folded into its conv or
# pool, one real transpose (the s2d stem's 6-D permute) and no other
PLAN_KINDS = {
    'ConvNet': {'add_const', 'conv2d', 'matmul', 'max_pool', 'relu', 'reshape'},
    'LeNet': {'add_const', 'conv2d', 'matmul', 'max_pool', 'relu', 'reshape'},
    'ResNet-20': {'add', 'add_const', 'affine', 'conv2d', 'matmul', 'mean', 'relu'},
    'ResNet-18-s2d': {'add', 'add_const', 'affine', 'conv2d', 'matmul', 'max_pool', 'mean',
                      'relu', 'reshape', 'transpose'},
    'ResNet-50': {'add', 'add_const', 'affine', 'conv2d', 'matmul', 'max_pool', 'mean', 'relu'},
    'MobileNet-v1': {'add_const', 'affine', 'conv2d', 'depthwise_conv2d', 'matmul', 'mean',
                     'minimum_const', 'relu'},
    'MobileNet-v2': {'add', 'add_const', 'affine', 'conv2d', 'depthwise_conv2d', 'matmul',
                     'mean', 'minimum_const', 'relu'},
}


@pytest.mark.parametrize('name', sorted(PLAN_KINDS))
def test_every_classification_net_lowers(name):
    import tensorflow as tf
    model, shape = _port_net(name)
    model.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for module in model.modules():
            if hasattr(module, 'var') and hasattr(module, 'mean'):
                module.mean.normal_(0.0, 0.1, generator=gen)
                module.var.uniform_(0.5, 1.5, generator=gen)
                module.scale.uniform_(0.5, 1.5, generator=gen)
    plan = tf_lowering.lower(model, shape)
    assert set(plan.counts()) == PLAN_KINDS[name], plan.counts()
    assert plan.counts().get('transpose', 0) == (name == 'ResNet-18-s2d')
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = tf_lowering.emit_tf(plan)(tf.constant(x)).numpy()
    want = _live(model, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


class _Planted(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))

    def forward(self, x):
        return torch.sigmoid(x.mean(dim=(1, 2)) * self.w)


def test_op_outside_the_table_raises():
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ConvNet
    with pytest.raises(NotImplementedError, match=r'at node mul.*aten\.mul\.Tensor'):
        tf_lowering.lower(_Planted(), (2, 8, 8, 3))
    # a bf16 net's casts are outside the table too (TFLite builtins are fp32)
    with pytest.raises(NotImplementedError, match='cast'):
        tf_lowering.lower(ConvNet(10, torch.bfloat16), (2, 28, 28, 1))


# ---------------------------------------------------------------------------
# the artifacts against the live model and the JAX exporter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['convnet', 'resnet20', 'mobilenet_v1', 'resnet18_s2d'])
def test_float_tflite_matches_live_and_jax(zoo, tmp_path, name):
    jmodel, variables, model, images = zoo(name)
    # through the bridge: the port exporter takes the JAX trees as they are
    path = ptfl.export_tflite(model, variables, images, str(tmp_path / 'model'))
    with open(path, 'rb') as fin:
        got = ptfl.run_tflite(fin.read(), images)
    live = _live(model, images)
    assert got.shape == live.shape
    np.testing.assert_allclose(got, live, atol=LIVE_ATOL)
    want = ptfl.run_tflite(jtfl.convert_to_tflite(jmodel, variables, images), images)
    delta = float(np.abs(got - want).max())
    print('TFLITE float %s: port vs live %.3e, port vs JAX %.3e (tol %.3e), max|logit| %.3f'
          % (name, float(np.abs(got - live).max()), delta, _cross_tol(want),
             float(np.abs(want).max())))
    assert delta <= _cross_tol(want)


def test_tflite_dynamic_quant_shrinks_weights(zoo):
    _, _, model, images = zoo('convnet')
    blob_f = ptfl.convert_to_tflite(model, None, images, quantize='none')
    blob_d = ptfl.convert_to_tflite(model, None, images, quantize='dynamic')
    # int8 weight storage: the dominant dense kernel shrinks ~4x
    assert len(blob_d) < 0.5 * len(blob_f)
    got = ptfl.run_tflite(blob_d, images)
    ref = _live(model, images)
    spread = float(ref.max() - ref.min()) + 1e-6
    assert float(np.max(np.abs(got - ref))) < 0.25 * spread


def test_tflite_full_int8_uint8_input(zoo):
    import tensorflow as tf
    jmodel, variables, model, images = zoo('convnet')
    blob = ptfl.convert_to_tflite(model, None, images, quantize='int8', input_uint8=True)
    interp = tf.lite.Interpreter(model_content=blob)
    interp.allocate_tensors()
    assert interp.get_input_details()[0]['dtype'] == np.uint8
    got = ptfl.run_tflite(blob, images)
    assert got.shape == (2, 10) and got.dtype == np.float32
    assert np.all(np.isfinite(got))
    # reported, not asserted: top-1 against the JAX int8 artifact on the same
    # weights and calibration batch
    want = ptfl.run_tflite(jtfl.convert_to_tflite(jmodel, variables, images, quantize='int8',
                                                  input_uint8=True), images)
    print('TFLITE int8 convnet: top-1 agreement with JAX %.3f, max |port - JAX| %.3e'
          % (float((got.argmax(-1) == want.argmax(-1)).mean()), float(np.abs(got - want).max())))


def test_saved_model_export(zoo, tmp_path):
    import tensorflow as tf
    _, _, model, images = zoo('resnet20')
    out = ptfl.export_saved_model(model, None, images, str(tmp_path / 'saved'))
    restored = tf.saved_model.load(out)
    ref = _live(model, images)
    np.testing.assert_allclose(np.asarray(restored.serve(tf.constant(images))), ref,
                               atol=SAVED_ATOL)
    served = restored.signatures['serving_default'](images=tf.constant(images))
    np.testing.assert_allclose(np.asarray(next(iter(served.values()))), ref, atol=SAVED_ATOL)


@pytest.mark.parametrize('how', ['compute_dtype', 'parameter'])
def test_tflite_rejects_bf16_models(how):
    """bf16 models fail with the rebuild-as-f32 error, not a converter's
    legalization failure."""
    from pocketflow_tpu_torch.nets.mobilenet import MobileNetV1
    x = np.random.default_rng(0).random((1, 32, 32, 3)).astype(np.float32)
    if how == 'compute_dtype':
        model = MobileNetV1(10, dtype=torch.bfloat16)
    else:
        model = MobileNetV1(10, dtype=torch.float32)
        model.logits.bias.data = model.logits.bias.data.to(torch.bfloat16)
    with pytest.raises(ValueError, match='bfloat16'):
        ptfl.convert_to_tflite(model, None, x)


def test_tflite_latency_protocol(zoo):
    _, _, model, images = zoo('convnet')
    blob = ptfl.convert_to_tflite(model, None, images, quantize='none')
    res = ptfl.measure_latency(blob, nb_warmup=2, nb_timed=5)
    assert set(res) == {'mean_ms', 'std_ms', 'p50_ms'}
    assert res['mean_ms'] > 0.0 and res['p50_ms'] > 0.0


# ---------------------------------------------------------------------------
# the QAT deploy path
# ---------------------------------------------------------------------------

def _kernel_paths(model):
    from pocketflow_tpu_torch.nn.layers import PFConv, PFDense
    return [m.path for m in model.modules() if isinstance(m, (PFConv, PFDense))]


def test_grouped_fold_equals_per_site_plain_and_jax(zoo):
    """The deploy fold (one grouped K2' call) is bit-equal, kernel by kernel,
    to per-site fake_quant_channel_bucket and to _column_plain; JAX folds
    under jax.jit, where XLA rounds alpha*round(.)/k+beta in another order:
    held within JIT_FOLD_ULPS fp32 roundings (2^-23) of each column's
    largest magnitude."""
    from pocketflow_tpu.learners.weight_sparsification import masking
    from pocketflow_tpu.ops import fake_quant as jfq
    from pocketflow_tpu_torch.learners.uniform_quantization.utils import quant_weights
    from pocketflow_tpu_torch.learners.uniform_quantization_tf import learner  # noqa: F401
    from pocketflow_tpu_torch.ops import fake_quant as fq
    _, variables, model, images = zoo('mobilenet_v1')
    paths = _kernel_paths(model)
    assert len(paths) == 28
    spec = {'weight_paths': paths, 'act_min': np.zeros(0, np.float32),
            'act_max': np.zeros(0, np.float32), 'weight_bits': 4, 'act_bits': 8}
    # flags deliberately differ from the spec: the spec's bits win
    with TFLAGS.scope(uqtf_weight_bits=8, uqtf_activation_bits=8):
        deploy, qat_ref = ptfl.build_qat_deploy_forward(model, None, spec)
    folded = quant_weights(deploy.model, paths)
    bits = torch.tensor(4.0)
    jfold = jax.jit(lambda p: jax.tree_util.tree_map_with_path(
        lambda path, leaf: jfq.fake_quant_channel_bucket(leaf, jnp.asarray(4.0, jnp.float32))
        if masking.path_str(path).endswith('/kernel') else leaf, p))(variables['params'])
    worst = 0.0
    for path, kernel, got in zip(paths, [k.detach() for k in quant_weights(model, paths)],
                                 [k.detach() for k in folded]):
        assert torch.equal(got, fq.fake_quant_channel_bucket(kernel, bits)), path
        assert torch.equal(got, fq._column_plain(kernel, fq._levels(bits), None)), path
        want = np.asarray(jax.device_get(_leaf(jfold, path + '/kernel')))
        # one fp32 rounding of each column's largest magnitude
        ulp = 2.0 ** -23 * kernel.reshape(-1, kernel.shape[-1]).abs().max(0).values.numpy()
        err = np.abs(got.numpy() - want).reshape(-1, kernel.shape[-1])
        worst = max(worst, float((err / ulp).max()))
        assert np.all(err <= JIT_FOLD_ULPS * ulp), path
    print('TFLITE fold vs JAX jit: worst |delta| %.3f fp32 roundings of the column' % worst)
    # with no activation sites, the deploy forward (folded kernels) is the QAT
    # reference (kernels quantized by the policy) exactly
    out_deploy, out_ref = ptfl._reference(deploy, images), ptfl._reference(qat_ref, images)
    np.testing.assert_array_equal(out_deploy, out_ref)
    assert float(np.abs(out_deploy - _live(model, images)).max()) > 1e-4


def _leaf(tree, path):
    for key in path.split('/'):
        tree = tree[key]
    return tree


def test_int8_qat_export_carries_trained_ranges(zoo, tmp_path):
    """The int8 artifact reproduces the QAT eval forward, not a PTQ
    recalibration of the float model: ConvNet trained for 30 SGD steps on
    the synthetic FMNIST task (from the JAX init), each activation site's
    range its max over the batch capped at 0.8 by hand, so that the ranges
    clip the function hard."""
    from pocketflow_tpu_torch.core.bridge import to_jax_numpy
    from pocketflow_tpu_torch.datasets.fmnist import FMnistDataset
    from pocketflow_tpu_torch.nn.layers import CompressionPolicy, compression
    jmodel, _, model, _ = zoo('convnet')
    model = copy.deepcopy(model)
    with TFLAGS.scope(synthetic_data=True):
        train, test = FMnistDataset(is_train=True), FMnistDataset(is_train=False)
        x, y = train.synthesize_arrays(480)
        x = train.augment(torch.from_numpy(x), None, False)
        images = test.augment(torch.from_numpy(test.synthesize_arrays(64)[0][:32]), None,
                              False).numpy()
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    model.train()
    for i in range(30):
        rows = slice(16 * i, 16 * (i + 1))
        loss = torch.nn.functional.cross_entropy(model(x[rows]), torch.from_numpy(y[rows]).long())
        opt.zero_grad()
        loss.backward()
        opt.step()
    model.eval()

    class Ranges(CompressionPolicy):
        found = []

        def process_act(self, path, act):
            if path.startswith('act/'):
                self.found.append(float(act.max()))
            return act

    with torch.no_grad(), compression(Ranges()):
        model(torch.from_numpy(images))
    spec = {'weight_paths': ['conv1', 'conv2', 'fc3', 'fc4'],
            'act_min': np.zeros(3, np.float32),
            'act_max': np.minimum(np.asarray(Ranges.found, np.float32), 0.8),
            'weight_bits': 8, 'act_bits': 8}
    _, qat_ref = ptfl.build_qat_deploy_forward(model, None, spec)
    ref_qat, ref_float = ptfl._reference(qat_ref, images), _live(model, images)
    clip_effect = float(np.abs(ref_qat - ref_float).max())
    assert clip_effect > 0.5, clip_effect  # the ranges genuinely bite

    path = ptfl.export_tflite(model, None, images, str(tmp_path / 'model_qat'),
                              quantize='int8', qat_spec=spec)
    with open(path, 'rb') as fin:
        out = ptfl.run_tflite(fin.read(), images)
    d_qat = float(np.abs(out - ref_qat).max())
    d_float = float(np.abs(out - ref_float).max())
    scale = float(np.abs(ref_qat).max())
    assert d_qat < 0.05 * scale + 0.05, (d_qat, scale)
    assert d_float > 5 * d_qat, (d_float, d_qat)
    assert (out.argmax(-1) == ref_qat.argmax(-1)).mean() == 1.0
    # JAX's artifact on the same weights and spec
    params, stats = to_jax_numpy(model)
    jpath = jtfl.export_tflite(jmodel, {'params': params, 'batch_stats': stats}, images,
                               str(tmp_path / 'jax_qat'), quantize='int8', qat_spec=spec)
    with open(jpath, 'rb') as fin:
        want = ptfl.run_tflite(fin.read(), images)
    cross = float(np.abs(out - want).max())
    print('TFLITE int8-qat convnet: clip %.3f, d_qat %.4f, d_float %.3f, scale %.3f, port vs '
          'JAX %.4f, top-1 agreement with JAX %.3f' % (
              clip_effect, d_qat, d_float, scale, cross,
              float((out.argmax(-1) == want.argmax(-1)).mean())))
    assert cross < 0.05 * scale + 0.05, (cross, scale)


# ---------------------------------------------------------------------------
# export_cli
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def qat_checkpoint(tmp_path_factory):
    """A port checkpoint of ResNet-20 (JAX init through the bridge, BN moved,
    input channels 0-2 zeroed in every consumer) with the uniform-tf
    learner's activation ranges in its extra: each site's range over the
    sample, its max capped at 2."""
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.nets.resnet import ResNetCifar
    from pocketflow_tpu_torch.nn.layers import CompressionPolicy, compression
    from tests.test_shrink_residual import _zero_in_channels
    _, variables, _, images = _build('resnet20')
    model = ResNetCifar(3, 10, torch.float32)
    load_jax_numpy(model, _zero_in_channels(variables['params'], [0, 1, 2]),
                   variables['batch_stats'])

    class Ranges(CompressionPolicy):
        found = []

        def process_act(self, path, act):
            if path.startswith('act/'):
                self.found.append((float(act.min()), float(act.max())))
            return act

    with torch.no_grad(), compression(Ranges()):
        model.eval()(torch.from_numpy(images))
    ranges = np.asarray(Ranges.found, np.float32)
    ckpt = str(tmp_path_factory.mktemp('qat_ckpt') / 'models' / 'model.ckpt')
    ckpt_lib.save(ckpt, {'step': 0, 'model': model.state_dict(), 'optimizer': {},
                         'extra': {'act_min': torch.from_numpy(ranges[:, 0]),
                                   'act_max': torch.from_numpy(np.minimum(ranges[:, 1], 2.0))}},
                  0)
    return ckpt


@pytest.mark.parametrize('mode,export_mode', [('float', 'plain'), ('dynamic', 'chn-pruned'),
                                              ('int8', 'chn-pruned-residual'),
                                              ('int8-qat', 'chn-pruned-residual')])
def test_export_cli_writes_each_tflite_mode(qat_checkpoint, tmp_path, mode, export_mode):
    import tensorflow as tf
    from pocketflow_tpu_torch.tools import export_cli
    out = str(tmp_path / 'model')
    argv = ['--export_model=resnet_at_cifar10', '--synthetic_data', '--compute_dtype=float32',
            '--ckpt_path=%s' % qat_checkpoint, '--export_mode=%s' % export_mode,
            '--output_path=%s' % out, '--tflite_mode=%s' % mode, '--tflite_latency']
    if mode == 'float':
        argv.append('--export_saved_model')
    export_cli.main(argv, device='cpu')
    with open(out + '.tflite', 'rb') as fin:
        blob = fin.read()
    interp = tf.lite.Interpreter(model_content=blob)
    interp.allocate_tensors()
    idet = interp.get_input_details()[0]
    assert tuple(idet['shape']) == (2, 32, 32, 3)
    assert idet['dtype'] == (np.uint8 if mode.startswith('int8') else np.float32)
    got = ptfl.run_tflite(blob, np.random.default_rng(0).random((2, 32, 32, 3)))
    assert got.shape == (2, 10) and np.all(np.isfinite(got))
    if mode == 'float':
        restored = tf.saved_model.load(out + '_saved')
        assert 'serving_default' in restored.signatures


def test_export_cli_int8_qat_needs_trained_ranges(tmp_path):
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ConvNet
    from pocketflow_tpu_torch.tools import export_cli
    ckpt = str(tmp_path / 'models' / 'model.ckpt')
    model = ConvNet(10, torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    ckpt_lib.save(ckpt, {'step': 0, 'model': model.state_dict(), 'optimizer': {},
                         'extra': None}, 0)
    with pytest.raises(ValueError, match='trained activation ranges'):
        export_cli.main(['--export_model=convnet_at_fmnist', '--synthetic_data',
                         '--compute_dtype=float32', '--ckpt_path=%s' % ckpt,
                         '--output_path=%s' % (tmp_path / 'x'), '--tflite_mode=int8-qat'],
                        device='cpu')
