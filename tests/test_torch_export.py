"""The port's deployment path (pocketflow_tpu_torch/tools/{export,export_cli,
serving,model_report,benchmark,add_metadata}.py, core/bridge.to_jax_numpy)
against the JAX package's on the CPU, ResNet-20 @ CIFAR-10 in fp32:

* ``to_jax_numpy`` the inverse of the bridge, with the JAX tree's keys;
* packing (per tensor, channel and split buckets at 4 and 8 bits),
  unpacking, BN folding, ``shrink_channel_pruned`` and the .npz + manifest
  format equal to JAX's (arrays bit-equal, each package reading the other's
  files);
* a JAX-written artifact of each export mode ('plain', 'chn-pruned',
  'chn-pruned-residual', 'quant') served by the port, and a port-written one
  served by the JAX ``load_serving_model``: logits within 1e-5 of the
  largest logit of the other package's serving (fp32 convs summed in another
  order: the readings are at most 7.5e-7);
* ``export_cli.main`` on the CPU in each mode from a checkpoint that
  ``main.main`` wrote (input channels 0-2 zeroed in every consumer): the
  residual shrink's FLOPs audit, the physically smaller served net, the
  ``.pt2`` program reloaded with bit-equal logits;
* ``serving.main`` and ``model_report`` against the JAX package's;
* the TFLite / SavedModel flags raise NotImplementedError naming ROADMAP
  item 23, and each entry point refuses device='cuda' without a card.
"""

import contextlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.tools import export as jexport
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core.bridge import load_jax_numpy, to_jax_numpy
from pocketflow_tpu_torch.tools import export as texport
from tests.test_shrink_residual import _zero_in_channels

torch.set_num_threads(2)
MODES = ('plain', 'chn-pruned', 'chn-pruned-residual', 'quant')
ZEROED = [0, 1, 2]
# served logits of the two packages: fp32 convs summed in another order
CROSS_TOL = 1e-5
SMALL = dict(batch_size=4, batch_size_eval=4, resnet_size=20, nb_smpls_train=64,
             nb_smpls_eval=32, compute_dtype='float32', synthetic_data=True)


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
    with _flags_kept(TFLAGS), _flags_kept(JFLAGS):
        yield


def _images(seed=0, n=2):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


def _jax_net():
    from pocketflow_tpu.nets.resnet import ResNetCifar
    return ResNetCifar(nb_blocks=3, nb_classes=10, dtype=jnp.float32)


def _port_net(params=None, stats=None):
    from pocketflow_tpu_torch.nets.resnet import ResNetCifar
    model = ResNetCifar(3, 10, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    if params is not None:
        load_jax_numpy(model, params, stats)
    return model.eval()


def _logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(np.array(x))).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=CROSS_TOL * float(np.abs(want).max()))


@pytest.fixture(scope='module')
def jax_artifacts(tmp_path_factory):
    """A JAX checkpoint of ResNet-20 (BN statistics moved off their init,
    input channels 0-2 zeroed) exported by the JAX export_cli in each mode:
    (live params, batch_stats, {mode: artifact path})."""
    from pocketflow_tpu.core import checkpoint as ckpt_lib
    from pocketflow_tpu.learners.full_precision import FullPrecLearner
    from pocketflow_tpu.nets.resnet_at_cifar10 import ModelHelper
    from pocketflow_tpu.tools import export_cli
    root = tmp_path_factory.mktemp('jax_export')
    with _flags_kept(JFLAGS, **SMALL, save_path=str(root / 'models' / 'model.ckpt'),
                     log_dir=str(root / 'logs')):
        state, _, _ = FullPrecLearner(None, ModelHelper()).init_state()
        rng = np.random.default_rng(1)
        stats = jax.tree_util.tree_map_with_path(
            lambda p, v: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape) if p[-1].key == 'mean'
                          else np.asarray(v) * (1 + 0.2 * rng.random(v.shape))).astype(np.float32),
            jax.device_get(state.batch_stats))
        params = _zero_in_channels(jax.tree_util.tree_map(np.array, state.params), ZEROED)
        state = state.replace(params=params, batch_stats=stats)
        ckpt = str(root / 'models' / 'model.ckpt')
        ckpt_lib.save(ckpt, state, 0)
        out = {mode: export_cli.main([
            '--export_model=resnet_at_cifar10', '--resnet_size=20', '--synthetic_data',
            '--compute_dtype=float32', '--ckpt_path=%s' % ckpt, '--export_mode=%s' % mode,
            '--uql_weight_bits=8', '--output_path=%s' % (root / mode)]) for mode in MODES}
    return params, stats, out


@pytest.fixture(scope='module')
def port_artifacts(tmp_path_factory):
    """main.main's full-prec checkpoint of ResNet-20 (a few steps, input
    channels 0-2 then zeroed) exported by the port's export_cli in each
    mode on the CPU: (live port model, {mode: artifact path}, checkpoint)."""
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.tools import export_cli
    root = tmp_path_factory.mktemp('port_export')
    ckpt = str(root / 'models' / 'model.ckpt')
    # JSONL summaries spare the run TensorBoard's imports
    with _flags_kept(TFLAGS), pytest.MonkeyPatch.context() as patch:
        patch.setitem(sys.modules, 'torch.utils.tensorboard', None)
        port_main.main(['--model=resnet_at_cifar10', '--learner=full-prec', '--synthetic_data',
                        '--batch_size=4', '--batch_size_eval=4', '--nb_smpls_train=16',
                        '--nb_smpls_eval=8', '--nb_epochs_rat=0.01', '--compute_dtype=float32',
                        '--summ_step=1', '--log_dir=%s' % (root / 'logs'),
                        '--save_path=%s' % ckpt], device='cpu')
        payload = ckpt_lib.restore_latest(ckpt)
        model = _port_net()
        model.load_state_dict(payload['model'])
        params, stats = to_jax_numpy(model)
        load_jax_numpy(model, _zero_in_channels(params, ZEROED), stats)
        payload['model'] = model.state_dict()
        ckpt_lib.save(ckpt, payload, payload['step'] + 1)
        out = {mode: export_cli.main([
            '--export_model=resnet_at_cifar10', '--synthetic_data', '--compute_dtype=float32',
            '--ckpt_path=%s' % ckpt, '--export_mode=%s' % mode, '--uql_weight_bits=8',
            '--output_path=%s' % (root / mode)], device='cpu') for mode in MODES}
    return model, out, ckpt


def test_to_jax_numpy_inverts_the_bridge():
    from pocketflow_tpu_torch.tools.shrink_graph import tree_leaves
    x = jnp.asarray(_images())
    variables = jax.device_get(_jax_net().init(jax.random.PRNGKey(0), x, train=False))
    model = _port_net(variables['params'], variables['batch_stats'])
    params, stats = to_jax_numpy(model)
    for got, want in ((params, variables['params']), (stats, variables['batch_stats'])):
        got, want = tree_leaves(got), jax.tree_util.tree_leaves_with_path(want)
        assert [k for k, _ in got] == ['/'.join(p.key for p in path) for path, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize('bucket_type,bits', [(None, 4), ('channel', 8), ('split', 4)])
def test_packing_and_format_equal_jax(tmp_path, bucket_type, bits):
    rng = np.random.default_rng(bits)
    params = {'conv': {'kernel': rng.normal(size=(3, 3, 4, 8)).astype(np.float32)},
              'fc': {'bias': np.ones(8, np.float32),
                     'kernel': rng.normal(size=(40, 10)).astype(np.float32)}}
    want = jexport.pack_quantized(params, ['conv', 'fc'], [bits, 32], bucket_type, 16)
    got = texport.pack_quantized(params, ['conv', 'fc'], [bits, 32], bucket_type, 16)
    assert list(got) == list(want) and isinstance(got['conv/kernel'], dict)
    for key in ('codes', 'alpha', 'beta'):
        np.testing.assert_array_equal(got['conv/kernel'][key], want['conv/kernel'][key])
        assert got['conv/kernel'][key].dtype == want['conv/kernel'][key].dtype
    for key in ('fc/kernel', 'fc/bias'):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(texport.unpack_quantized(got)['conv/kernel'],
                                  jexport.unpack_quantized(want)['conv/kernel'])
    # each package reads the other's files, bit for bit
    tpath = texport.save_packed(got, {'note': 'port'}, str(tmp_path / 'port.npz'))
    jpath = jexport.save_packed(want, {'note': 'port'}, str(tmp_path / 'jax.npz'))
    with open(tpath + '.manifest.json') as a, open(jpath + '.manifest.json') as b:
        assert json.load(a) == json.load(b)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert a.files == b.files
    for loaded in (jexport.load_packed(tpath), texport.load_packed(jpath)):
        assert loaded['conv/kernel']['bits'] == bits
        np.testing.assert_array_equal(texport.unpack_quantized(loaded)['conv/kernel'],
                                      jexport.unpack_quantized(want)['conv/kernel'])


def test_fold_and_channel_shrink_equal_jax():
    x = jnp.asarray(_images(1))
    net = _jax_net()
    variables = jax.device_get(net.init(jax.random.PRNGKey(1), x, train=False))
    _, upd = net.apply(variables, x, train=True, mutable=['batch_stats'])
    stats = jax.tree_util.tree_map(np.array, jax.device_get(upd['batch_stats']))
    params = _zero_in_channels(jax.tree_util.tree_map(np.array, variables['params']), ZEROED)
    jp, js = jexport.fold_batch_norm(params, stats)
    tp, ts = texport.fold_batch_norm(params, stats)
    for got, want in ((tp, jp), (ts, js)):
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                     jax.tree_util.tree_leaves_with_path(want)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    # the folded tree serves the same eval logits (the JAX test's bound)
    ref = _logits(_port_net(params, stats), np.asarray(x))
    np.testing.assert_allclose(_logits(_port_net(tp, ts), np.asarray(x)), ref,
                               rtol=2e-4, atol=2e-4)
    jpacked, jman = jexport.shrink_channel_pruned(params)
    tpacked, tman = texport.shrink_channel_pruned(params)
    assert tman == jman and list(tpacked) == list(jpacked) and len(tman) == 20
    for key in tpacked:
        np.testing.assert_array_equal(tpacked[key], np.asarray(jpacked[key]), err_msg=key)


@pytest.mark.parametrize('mode', MODES)
def test_jax_artifact_serves_in_the_port(jax_artifacts, mode):
    from pocketflow_tpu.tools.serving import load_serving_model as jload
    from pocketflow_tpu_torch.tools.serving import load_serving_model
    params, stats, out = jax_artifacts
    x = _images(2)
    jmodel, jvars = jload(out[mode], _jax_net())
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False))
    dense = _port_net()
    served = load_serving_model(out[mode], dense)
    _close(_logits(served, x), want)
    shrunk = mode == 'chn-pruned-residual'
    assert (served.width_map is not None) == shrunk and dense.width_map is None
    if mode in ('plain', 'chn-pruned', 'chn-pruned-residual'):  # the live model's logits
        _close(_logits(served, x), _logits(_port_net(params, stats), x))


@pytest.mark.parametrize('mode', MODES)
def test_port_artifact_serves_in_jax(port_artifacts, mode):
    from pocketflow_tpu.tools.serving import load_serving_model as jload
    from pocketflow_tpu_torch.tools.serving import load_serving_model
    model, out, _ = port_artifacts
    x = _images(3)
    jmodel, jvars = jload(out[mode], _jax_net())
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False))
    served = load_serving_model(out[mode], _port_net())
    _close(_logits(served, x), want)
    if mode != 'quant':
        _close(_logits(served, x), _logits(model, x))
    else:  # 8-bit weight noise only
        ref = _logits(model, x)
        assert float(np.abs(_logits(served, x) - ref).max()) < 0.1 * float(ref.max() - ref.min())


def test_export_cli_modes_on_the_cpu(port_artifacts):
    """The residual artifact: its FLOPs audit, the shrunk served net; each
    mode's .pt2 program reloaded gives the live model's logits."""
    from pocketflow_tpu_torch.tools.serving import load_serving_model
    model, out, _ = port_artifacts
    with open(out['chn-pruned-residual'] + '.manifest.json') as fin:
        manifest = json.load(fin)
    assert manifest['components'] and manifest['flops_audit']['reduction'] > 0.1
    served = load_serving_model(out['chn-pruned-residual'], _port_net())
    assert served.fc.kernel.shape == (61, 10) and served.conv_init.kernel.shape[-1] == 13
    assert sum(p.numel() for p in served.parameters()) < sum(p.numel() for p in model.parameters())
    with open(out['chn-pruned'] + '.manifest.json') as fin:
        assert len(json.load(fin)) == 20  # every conv but the stem lost 3 input channels
    with open(out['quant'] + '.manifest.json') as fin:
        quant = json.load(fin)
    assert quant['weight_bits'] == 8 and len(quant['quantized']) == 20  # stem and fc stay fp32
    x = torch.from_numpy(_images(4))
    for mode, path in out.items():
        program = torch.export.load(path[:-len('.npz')] + '.pt2').module()
        with torch.no_grad():
            np.testing.assert_array_equal(program(x).numpy(), _logits(model, x.numpy()),
                                          err_msg=mode)


def test_serving_main_matches_jax(port_artifacts):
    from pocketflow_tpu.tools import serving as jserving
    from pocketflow_tpu_torch.tools import serving
    _, out, _ = port_artifacts
    path = out['chn-pruned-residual']
    with _flags_kept(TFLAGS, synthetic_data=True, compute_dtype='float32'):
        got = serving.main(['--artifact=%s' % path, '--export_model=resnet_at_cifar10',
                            '--serve_batch=2'], device='cpu')
    assert got['device'] == 'cpu' and got['latency_ms'] > 0 and got['logits'].shape == (2, 10)
    with _flags_kept(JFLAGS, **SMALL):
        assert jserving.main(['--artifact=%s' % path, '--export_model=resnet_at_cifar10',
                              '--serve_batch=2']) == 0
        from pocketflow_tpu.nets.resnet_at_cifar10 import ModelHelper
        ds = ModelHelper().build_dataset_eval()
        sample = ds.augment(jnp.asarray(ds.synthesize_arrays(2)[0][:2]),
                            jax.random.PRNGKey(0), False)
        jmodel, jvars = jserving.load_serving_model(path, _jax_net())
        want = np.asarray(jmodel.apply(jvars, sample, train=False))
    _close(got['logits'], want)


def test_model_report_matches_jax(port_artifacts):
    from pocketflow_tpu.tools import model_report as jreport
    from pocketflow_tpu_torch.tools import model_report
    model, _, ckpt = port_artifacts
    x = _images(5)
    params, stats = to_jax_numpy(model)
    want = jreport.build_report(_jax_net(), params, stats, jnp.asarray(x))
    got = model_report.build_report(model, torch.from_numpy(x))
    assert got == want
    conv = next(r for r in got['layers'] if r['layer'] == 'stage1_block0/conv1')
    assert conv['in_channels'] == 16 and conv['in_channels_kept'] == 13
    with _flags_kept(TFLAGS, synthetic_data=True, compute_dtype='float32'):
        report = model_report.main(['--report_model=resnet_at_cifar10',
                                    '--report_ckpt=%s' % ckpt], device='cpu')
    with _flags_kept(JFLAGS, **SMALL):
        jmain = jreport.main(['--report_model=resnet_at_cifar10'])
    assert report['total_params'] == jmain['total_params']
    assert report['total_conv_flops'] == jmain['total_conv_flops']
    assert report['layers'] == got['layers']


def test_add_metadata_writes_the_jax_sidecar(tmp_path):
    from pocketflow_tpu.tools import add_metadata as jmeta
    from pocketflow_tpu_torch.tools import add_metadata as tmeta
    for mod, name in ((tmeta, 'port'), (jmeta, 'jax')):
        mod.add_metadata(str(tmp_path / name), 'resnet_20', 'cifar_10', (1, 32, 32, 3), 10,
                         {'export_mode': 'plain'})
    with open(tmp_path / 'port.meta.json') as a, open(tmp_path / 'jax.meta.json') as b:
        assert a.read() == b.read()
    assert tmeta.read_metadata(str(tmp_path / 'port'))['input_shape'] == [1, 32, 32, 3]
    assert tmeta.read_metadata(str(tmp_path / 'none')) is None


def test_tflite_flags_raise_and_entry_points_need_the_card(port_artifacts, tmp_path):
    from pocketflow_tpu_torch.tools import export_cli, model_report, serving
    _, out, ckpt = port_artifacts
    common = ['--export_model=resnet_at_cifar10', '--synthetic_data', '--compute_dtype=float32',
              '--ckpt_path=%s' % ckpt, '--output_path=%s' % (tmp_path / 'x')]
    for extra in (['--tflite_mode=int8'], ['--export_saved_model']):
        with pytest.raises(NotImplementedError, match='item 23'):
            export_cli.main(common + extra, device='cpu')
    assert not os.path.exists(str(tmp_path / 'x.npz'))
    if not torch.cuda.is_available():
        for entry, argv in ((export_cli.main, common),
                            (serving.main, ['--artifact=%s' % out['plain']]),
                            (model_report.main, ['--report_model=resnet_at_cifar10'])):
            with pytest.raises(RuntimeError, match='cuda'):
                entry(argv)
