"""Package-level checks of the PyTorch port: no JAX in its import graph, the
flag surface shared with the JAX package, the bridge's refusals, the kernel
wrappers' device rule, checkpoints, and main.py end to end on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pocketflow_tpu_torch.config import FLAGS as TFLAGS

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_flags():
    """Restore every flag of the port's registry after each test (conftest
    scopes only the JAX registry)."""
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _port_modules():
    names = []
    root = os.path.join(REPO, 'pocketflow_tpu_torch')
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith('.py'):
                rel = os.path.relpath(os.path.join(dirpath, name), REPO)[:-3]
                names.append(rel.replace(os.sep, '.').replace('.__init__', ''))
    return sorted(names)


def test_port_imports_no_jax():
    code = ('import importlib, json, sys\n'
            'for name in %r:\n'
            '    importlib.import_module(name)\n'
            'print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "optax", "pocketflow_tpu"))))\n' % _port_modules())
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-S', '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 and 'No module named' in proc.stderr:
        # -S drops site-packages; rerun with them but still no sitecustomize
        proc = subprocess.run([sys.executable, '-I', '-c',
                               'import sys; sys.path.insert(0, %r)\n' % REPO + code],
                              cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert len(_port_modules()) >= 20


def test_every_port_flag_exists_in_jax_registry_with_same_default():
    import pocketflow_tpu  # noqa: F401  (registers the JAX package's whole flag surface)
    import pocketflow_tpu.utils.path_args  # noqa: F401  (--path_conf, defined for main.py)
    from pocketflow_tpu.config import FLAGS as JFLAGS
    import importlib
    for name in _port_modules():  # every flag the port defines
        importlib.import_module(name)
    port = TFLAGS.defaults()
    port.pop('model', None)  # defined by either main() at call time
    missing = sorted(name for name in port if name not in JFLAGS)
    assert not missing
    jax_defaults = JFLAGS.as_dict()
    with JFLAGS.scope():
        differ = {name: (port[name], JFLAGS._specs[name].default) for name in port
                  if JFLAGS._specs[name].default != port[name]}
    assert not differ and jax_defaults is not None


def test_bridge_raises_on_unmapped_and_unset_entries():
    from pocketflow_tpu_torch.core.bridge import from_jax_numpy, load_jax_numpy
    from pocketflow_tpu_torch.nn.layers import BatchNorm, PFConv
    with pytest.raises(KeyError):
        from_jax_numpy({'conv': {'codebook': np.zeros(4)}}, {})
    with pytest.raises(KeyError):
        from_jax_numpy({'conv': {'scale': np.zeros(4)}}, {})  # scale outside a BN
    with pytest.raises(KeyError):
        from_jax_numpy({}, {'bn1': {'bn': {'count': np.zeros(4)}}})
    conv = PFConv(3, 4, (3, 3), use_bias=True, dtype=torch.float32)
    with pytest.raises(KeyError):  # bias left unset
        load_jax_numpy(conv, {'kernel': np.zeros((3, 3, 3, 4), np.float32)}, {})
    with pytest.raises(ValueError):  # OIHW is not the bridge's layout
        load_jax_numpy(conv, {'kernel': np.zeros((4, 3, 3, 3), np.float32),
                              'bias': np.zeros(4, np.float32)}, {})
    bn = BatchNorm(4, dtype=torch.float32)
    load_jax_numpy(bn, {'bn': {'scale': np.full(4, 2.0, np.float32),
                               'bias': np.ones(4, np.float32)}},
                   {'bn': {'mean': np.ones(4, np.float32), 'var': np.full(4, 3.0, np.float32)}})
    assert float(bn.bn.var[0]) == 3.0 and float(bn.bn.scale.detach()[0]) == 2.0


@pytest.mark.parametrize('op', ['per_tensor', 'per_column', 'fake_quant', 'group', 'select',
                                'column_group'])
def test_kernel_wrappers_raise_off_cpu_and_cuda(op):
    from pocketflow_tpu_torch.ops import fake_quant as fq
    x = torch.empty((8, 8), device='meta')
    bits = torch.empty((), device='meta')
    fn = {'per_tensor': fq.fake_quant_per_tensor, 'per_column': fq.fake_quant_channel_bucket,
          'fake_quant': fq.fake_quant,
          'group': lambda x, b: fq.fake_quant_per_tensor_group([x], b.reshape(1)),
          'select': fq.fake_quant_select,
          'column_group': lambda x, b: fq.fake_quant_per_column_group([x], b.reshape(1), 4)}[op]
    with pytest.raises(ValueError, match='no kernel for device'):
        fn(x, bits)


def test_profile_step_summarizes_device_events():
    """tools/profile_step.py's per-step summary, on made-up device records
    (name, start us, end us) of 2 steps: busy time is the union of the
    intervals, and every record lands in one layer."""
    from pocketflow_tpu_torch.tools import profile_step as ps
    events = [('void at::native::batch_norm_collect_statistics_channels_last_kernel', 0, 400),
              ('sm90_xmma_fprop_implicit_gemm_bf16bf16', 300, 1000),
              ('void (anonymous namespace)::tensor_quantize_f32<4>(float const*)', 1500, 1600),
              ('Memcpy HtoD (Pinned -> Device)', 1600, 1700),
              ('void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add>', 1900, 2000),
              ('some_unknown_kernel', 2000, 2100)]
    summary = ps.summarize(events, nb_steps=2)
    assert summary['window_ms_per_step'] == pytest.approx(2100 / 2 / 1e3)
    # busy: 0-1000, 1500-1700, 1900-2100
    assert summary['busy_ms_per_step'] == pytest.approx(1400 / 2 / 1e3)
    assert summary['idle_share'] == pytest.approx(1 - 1400 / 2100)
    assert summary['by_category_ms_per_step'] == pytest.approx({
        'conv/matmul (cuDNN, cuBLAS)': 0.35, 'batch norm': 0.2, 'fake-quant kernels': 0.05,
        'copies/layout/pad': 0.05, 'elementwise': 0.05, 'other': 0.05})
    with pytest.raises(RuntimeError, match='no device activity'):
        ps.summarize([], nb_steps=1)


def test_learner_refuses_missing_cuda_and_unported_names():
    """create_learner refuses a missing card and an unknown name, and builds
    every learner of the JAX package on the CPU, the four channel-pruning
    ones included (none is left unported)."""
    from pocketflow_tpu_torch.learners import create_learner, learner_utils
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper
    with TFLAGS.scope(ilsvrc_image_size=32, synthetic_data=True):
        helper = ModelHelper(resnet_size=18)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match='cuda'):
                create_learner(None, helper, 'full-prec')
        classes = {'channel': 'ChannelPrunedLearner', 'chn-pruned-gpu': 'ChannelPrunedGpuLearner',
                   'chn-pruned-rmt': 'ChannelPrunedRmtLearner',
                   'dis-chn-pruned': 'DisChnPrunedLearner'}
        for name, cls in classes.items():
            learner = create_learner(None, helper, name, device='cpu')
            assert type(learner).__name__ == cls and learner.device.type == 'cpu'
        assert not hasattr(learner_utils, '_NOT_PORTED')
        with pytest.raises(ValueError):
            create_learner(None, helper, 'no-such-learner', device='cpu')


def test_checkpoint_roundtrip(tmp_path):
    from pocketflow_tpu_torch.core import checkpoint as ckpt
    save_path = str(tmp_path / 'm' / 'model.ckpt')
    assert ckpt.latest_checkpoint(str(tmp_path / 'm')) is None
    ckpt.save(save_path, {'step': 3, 'w': torch.ones(2)}, 3)
    path = ckpt.save(save_path, {'step': 7, 'w': torch.full((2,), 5.0)}, 7)
    assert ckpt.latest_checkpoint(str(tmp_path / 'm')) == path
    payload = ckpt.restore_latest(save_path)
    assert payload['step'] == 7 and torch.equal(payload['w'], torch.full((2,), 5.0))


def test_main_trains_baseline_then_qat_then_evaluates_on_cpu(tmp_path, monkeypatch):
    """python -m pocketflow_tpu_torch.main, full-prec then uniform (restoring
    the baseline) then uniform eval, at a tiny size on the CPU."""
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.core import checkpoint as ckpt
    from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset
    from pocketflow_tpu_torch.ops import fake_quant as fq
    # 64 synthetic samples instead of 2048 keep the eval loops short, and the
    # JSONL summaries spare the test TensorBoard's imports
    monkeypatch.setattr(Ilsvrc12Dataset, '_load_arrays', lambda self: self.synthesize_arrays(64))
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    common = ['--model=resnet_at_ilsvrc12', '--resnet_size=50', '--synthetic_data',
              '--ilsvrc_image_size=32',
              '--batch_size=4', '--batch_size_eval=16', '--nb_smpls_train=16',
              '--nb_smpls_eval=8', '--nb_epochs_rat=0.01', '--compute_dtype=float32',
              '--resnet_stem_s2d', '--summ_step=1', '--log_dir=%s' % (tmp_path / 'logs'),
              '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt'),
              '--uql_save_quant_model_path=%s' % (tmp_path / 'uql' / 'model.ckpt')]
    port_main.main(common + ['--learner=full-prec'], device='cpu')
    assert ckpt.latest_checkpoint(str(tmp_path / 'models')).endswith('model.ckpt-4.pt')
    fq.reset_counters()
    port_main.main(common + ['--learner=uniform', '--uql_weight_bits=2'], device='cpu')
    payload = ckpt.restore_latest(str(tmp_path / 'uql' / 'model.ckpt'))
    assert payload['step'] == 2
    assert torch.equal(payload['extra']['w_bits'], torch.full((52,), 2.0))
    # each forward quantizes the 52 weights in one grouped call: 2 train steps, and evals
    assert fq.counters()['plain'] >= 2
    port_main.main(common + ['--learner=uniform', '--exec_mode=eval'], device='cpu')
    with open(tmp_path / 'logs' / 'scalars.jsonl') as fin:
        tags = {json.loads(line)['tag'] for line in fin}
    assert {'train/loss', 'train/accuracy', 'train/speed'} <= tags
    # the detectors are registered: each parses and reaches its learner
    for model in ('vgg_at_pascalvoc', 'faster_rcnn_at_pascalvoc'):
        assert model in port_main.MODELS
        with pytest.raises(ValueError, match='unrecognized execution mode'):
            port_main.main(common + ['--model=%s' % model, '--learner=full-prec',
                                     '--exec_mode=none'], device='cpu')
