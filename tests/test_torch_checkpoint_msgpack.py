"""The port reads the JAX package's checkpoints (pocketflow_tpu_torch/core/
checkpoint.py) and fetches pretrained ones (``download_model``), on the CPU:

* the msgpack decoder equals ``flax.serialization.msgpack_restore`` on
  checkpoints the JAX ``save`` wrote: full-prec ResNet-20 with flax's chunk
  size patched down (its larger leaves chunked), uniform-tf ConvNet (with
  its extra), and the same with bfloat16 parameters;
* ``restore_latest`` through a port learner's ``restore_model``: logits
  equal to the JAX forward within fp32 rounding, BN statistics, step, extra
  and the SGD momentum buffers equal to optax's trace;
* ``export_cli`` on a JAX uniform-tf checkpoint: its int8-qat artifact
  within 0.05 max|logit| + 0.05 of the JAX export_cli's on the same
  checkpoint;
* ``download_model`` from ``file://`` tarballs: each branch.
"""

import contextlib
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import pocketflow_tpu.nets.resnet_at_cifar10  # noqa: F401  (--resnet_size)
import pocketflow_tpu_torch.nets.resnet_at_cifar10  # noqa: F401  (--resnet_size)
from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.core import checkpoint as jckpt
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
from torch_cli_flags import drop_export_cli_flags

torch.set_num_threads(2)
SMALL = dict(batch_size=4, batch_size_eval=4, nb_smpls_train=64, nb_smpls_eval=32,
             compute_dtype='float32', synthetic_data=True, resnet_size=20)


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


def _random_like(tree, rng):
    return jax.tree_util.tree_map(
        lambda v: rng.standard_normal(np.shape(v)).astype(np.float32), jax.device_get(tree))


def _jax_state(kind, root):
    """A JAX TrainState of `kind` with every leaf moved off its init (BN
    statistics, optax's momentum trace, the uniform-tf ranges), and the
    helper's name.  'bf16': the uniform-tf state with bfloat16 params."""
    from pocketflow_tpu.learners.full_precision import FullPrecLearner
    from pocketflow_tpu.learners.uniform_quantization_tf.learner import UniformQuantTFLearner
    from pocketflow_tpu.nets import convnet_at_fmnist, resnet_at_cifar10
    rng = np.random.default_rng(3)
    with _flags_kept(JFLAGS, **SMALL, save_path=str(root / 'fp' / 'model.ckpt'),
                     log_dir=str(root / 'logs')):
        if kind == 'full-prec':
            state, _, _ = FullPrecLearner(None, resnet_at_cifar10.ModelHelper()).init_state()
            helper = 'resnet_at_cifar10'
        else:
            state, _, _ = UniformQuantTFLearner(
                None, convnet_at_fmnist.ModelHelper()).init_state_quant()
            helper = 'convnet_at_fmnist'
    trace = state.opt_state[0]
    state = state.replace(
        step=jnp.asarray(5 if kind == 'full-prec' else 7, jnp.int32),
        batch_stats=jax.tree_util.tree_map(
            lambda v: np.abs(np.asarray(v) + rng.random(v.shape).astype(np.float32)),
            jax.device_get(state.batch_stats)),
        opt_state=(trace._replace(trace=_random_like(trace.trace, rng)),) + state.opt_state[1:])
    if kind != 'full-prec':
        state = state.replace(extra={'act_min': -rng.random(3).astype(np.float32),
                                     'act_max': 1 + rng.random(3).astype(np.float32)})
    if kind == 'bf16':
        state = state.replace(params=jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.bfloat16), state.params))
    return state, helper


@pytest.fixture(scope='module')
def jax_checkpoints(tmp_path_factory):
    """{kind: (state, helper name, checkpoint path)} written by the JAX
    package's save; full-prec with flax's chunk size at 4 KiB."""
    root = tmp_path_factory.mktemp('jax_ckpts')
    out = {}
    for kind in ('full-prec', 'uniform-tf', 'bf16'):
        state, helper = _jax_state(kind, root)
        save_path = str(root / kind / 'model.ckpt')
        with pytest.MonkeyPatch.context() as patch:
            if kind == 'full-prec':
                patch.setattr(serialization, 'MAX_CHUNK_SIZE', 1 << 12)
            path = jckpt.save(save_path, state, int(state.step))
        out[kind] = (state, helper, path)
    return out


def _same_tree(want, got, where=''):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), where
        for key in want:
            _same_tree(want[key], got[key], where + '/' + key)
    elif str(getattr(want, 'dtype', '')) == 'bfloat16':
        assert torch.is_tensor(got) and got.dtype == torch.bfloat16, where
        np.testing.assert_array_equal(np.asarray(want, np.float32), got.float().numpy())
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, where
        assert np.shape(got) == np.shape(want), where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


@pytest.mark.parametrize('kind', ['full-prec', 'uniform-tf', 'bf16'])
def test_decoder_equals_flax(jax_checkpoints, kind):
    _, _, path = jax_checkpoints[kind]
    with open(path, 'rb') as fin:
        data = fin.read()
    if kind == 'full-prec':
        assert b'__msgpack_chunked_array__' in data
    _same_tree(serialization.msgpack_restore(data), ckpt_lib.msgpack_restore(data))


def test_decoder_refuses_a_truncated_file(jax_checkpoints):
    with open(jax_checkpoints['uniform-tf'][2], 'rb') as fin:
        data = fin.read()
    with pytest.raises(ValueError, match='truncated'):
        ckpt_lib.msgpack_restore(data[:-3])


@pytest.mark.parametrize('kind', ['full-prec', 'uniform-tf', 'bf16'])
def test_restore_model_reads_the_jax_state(jax_checkpoints, kind):
    """A port learner restores the JAX TrainState: the same logits, BN
    statistics, step, extra and momentum."""
    import importlib
    from pocketflow_tpu_torch.core.bridge import to_jax_numpy
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
    state, helper_name, path = jax_checkpoints[kind]
    module = 'pocketflow_tpu.nets.%s' % helper_name
    save_path = os.path.join(os.path.dirname(path), 'model.ckpt')
    assert ckpt_lib.latest_checkpoint(os.path.dirname(path)) == path
    with _flags_kept(TFLAGS, **SMALL, save_path=save_path):
        helper = importlib.import_module(module.replace('pocketflow_tpu', 'pocketflow_tpu_torch'))
        learner = FullPrecLearner(None, helper.ModelHelper(), device='cpu')
        target, _, _ = learner.init_state()
        restored = learner.restore_model(target)
    with _flags_kept(JFLAGS, **SMALL):
        jmodel = importlib.import_module(module).ModelHelper().create_model()
    assert restored.step == int(state.step)
    params = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), state.params)
    got_params, got_stats = to_jax_numpy(restored.model)
    _same_tree(params, got_params)
    _same_tree(jax.device_get(state.batch_stats), got_stats)
    shape = (2, 32, 32, 3) if helper_name == 'resnet_at_cifar10' else (2, 28, 28, 1)
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    want = np.asarray(jmodel.apply({'params': params, 'batch_stats': state.batch_stats},
                                   jnp.asarray(x), train=False))
    with torch.no_grad():
        got = restored.model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    # every momentum buffer is optax's trace leaf of the same parameter
    names = {id(p): n for n, p in restored.model.named_parameters()}
    buffers = {names[id(p)]: s['momentum_buffer'] for p, s in restored.optimizer.state.items()}
    trace = {k: v for k, v in _flat(state.opt_state[0].trace).items()}
    assert sorted(buffers) == sorted(k.replace('/', '.') for k in trace)
    for key, value in trace.items():
        np.testing.assert_array_equal(buffers[key.replace('/', '.')].numpy(), value)
    if kind == 'full-prec':
        assert restored.extra is None
    else:
        for key in ('act_min', 'act_max'):
            np.testing.assert_array_equal(restored.extra[key].numpy(), state.extra[key])


def _flat(tree, prefix=''):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, prefix + key + '/'))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def test_export_cli_int8_qat_on_a_jax_checkpoint(jax_checkpoints, tmp_path):
    """The port's export_cli and the JAX package's on one JAX-written
    uniform-tf checkpoint: int8-qat artifacts within the int8-qat bound of
    each other."""
    from pocketflow_tpu.tools import export_cli as jcli
    from pocketflow_tpu_torch.tools import export_cli, export_tflite as ptfl
    _, _, path = jax_checkpoints['uniform-tf']
    argv = ['--export_model=convnet_at_fmnist', '--synthetic_data', '--compute_dtype=float32',
            '--ckpt_path=%s' % os.path.join(os.path.dirname(path), 'model.ckpt'),
            '--tflite_mode=int8-qat']
    with _flags_kept(TFLAGS):
        export_cli.main(argv + ['--output_path=%s' % (tmp_path / 'port')], device='cpu')
    with _flags_kept(JFLAGS, **SMALL):
        jcli.main(argv + ['--output_path=%s' % (tmp_path / 'jax')])
    images = np.random.default_rng(0).random((2, 28, 28, 1)).astype(np.float32)
    with open(str(tmp_path / 'port.tflite'), 'rb') as fin:
        got = ptfl.run_tflite(fin.read(), images)
    with open(str(tmp_path / 'jax.tflite'), 'rb') as fin:
        want = ptfl.run_tflite(fin.read(), images)
    scale = float(np.abs(want).max())
    delta = float(np.abs(got - want).max())
    print('TFLITE int8-qat from a JAX checkpoint: port vs JAX %.4f (bound %.4f)'
          % (delta, 0.05 * scale + 0.05))
    assert delta < 0.05 * scale + 0.05


# ---------------------------------------------------------------------------
# download_model
# ---------------------------------------------------------------------------

def _tarball(path, files):
    """A .tar.gz at `path` holding {arcname: bytes}."""
    import io
    with tarfile.open(path, 'w:gz') as tar:
        for name, data in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return path


@pytest.fixture
def learner_at(tmp_path):
    """learner_at(save_dir, url): a port learner whose --save_path is under
    save_dir and --model_http_url is url."""
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper

    def make(save_dir, url):
        TFLAGS.override(**SMALL, save_path=str(save_dir / 'model.ckpt'), model_http_url=url)
        return FullPrecLearner(None, ModelHelper(), device='cpu')
    return make


def _jax_files(jax_checkpoints):
    _, _, path = jax_checkpoints['uniform-tf']
    ckpt_dir = os.path.dirname(path)
    return {name: open(os.path.join(ckpt_dir, name), 'rb').read() for name in os.listdir(ckpt_dir)}


def test_download_model_fetches_a_jax_checkpoint(jax_checkpoints, learner_at, tmp_path):
    files = {'models/sub/' + name: data for name, data in _jax_files(jax_checkpoints).items()}
    files['models/../../escape.txt'] = b'x'
    tar = _tarball(str(tmp_path / 'models.tar.gz'), files)
    save_dir = tmp_path / 'dl'
    learner = learner_at(save_dir, 'file://' + tar)
    learner.download_model()
    assert sorted(os.listdir(save_dir)) == sorted(['escape.txt'] + list(_jax_files(
        jax_checkpoints)))  # flattened by basename, nothing outside save_dir
    assert not os.path.exists(str(tmp_path / 'escape.txt'))
    payload = ckpt_lib.restore_latest(str(save_dir / 'model.ckpt'))
    assert payload['step'] == 7 and payload['extra']['act_min'].shape == (3,)
    os.remove(tar)
    learner.download_model()  # a checkpoint exists: a no-op, no fetch


def test_download_model_appends_the_reference_tarball_name(jax_checkpoints, learner_at,
                                                            tmp_path):
    base = tmp_path / 'remote'
    base.mkdir()
    _tarball(str(base / 'models_convnet_at_fmnist.tar.gz'), _jax_files(jax_checkpoints))
    save_dir = tmp_path / 'dl'
    learner_at(save_dir, 'file://%s/' % base).download_model()
    assert ckpt_lib.latest_checkpoint(str(save_dir)) is not None


def test_download_model_refusals(jax_checkpoints, learner_at, tmp_path, monkeypatch):
    from pocketflow_tpu_torch.learners import abstract_learner
    with pytest.raises(ValueError, match='model_http_url'):
        learner_at(tmp_path / 'a', None).download_model()
    twice = _tarball(str(tmp_path / 'twice.tar.gz'), {'a/checkpoint': b'{}', 'b/checkpoint': b'{}'})
    with pytest.raises(ValueError, match='duplicate basename'):
        learner_at(tmp_path / 'b', 'file://' + twice).download_model()
    empty = _tarball(str(tmp_path / 'empty.tar.gz'), {'readme.txt': b'no checkpoint'})
    with pytest.raises(FileNotFoundError, match='no checkpoint'):
        learner_at(tmp_path / 'c', 'file://' + empty).download_model()
    full = _tarball(str(tmp_path / 'full.tar.gz'), _jax_files(jax_checkpoints))
    monkeypatch.setattr(abstract_learner, 'DOWNLOAD_BYTES_BOUND', 100)
    with pytest.raises(ValueError, match='size bound'):
        learner_at(tmp_path / 'd', 'file://' + full).download_model()


def test_download_model_other_ranks_wait_and_fetch_nothing(jax_checkpoints, learner_at,
                                                           tmp_path, monkeypatch):
    from pocketflow_tpu_torch.core import mesh
    full = _tarball(str(tmp_path / 'full.tar.gz'), _jax_files(jax_checkpoints))
    learner = learner_at(tmp_path / 'e', 'file://' + full)
    barriers = []
    monkeypatch.setattr(mesh, 'auto_barrier', lambda: barriers.append(1))
    monkeypatch.setattr(mesh, 'is_primary_worker', lambda scope='global': False)
    with pytest.raises(FileNotFoundError, match='no checkpoint'):
        learner.download_model()  # rank 0 never wrote one here
    assert barriers == [1] and not os.path.exists(str(tmp_path / 'e'))
