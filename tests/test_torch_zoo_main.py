"""The model zoo through the port's entry points on the CPU, and the
distillation helper against the JAX package's.

* `python -m pocketflow_tpu_torch.main` with no --model (ConvNet @ FMNIST),
  `--model=lenet_at_cifar10 --learner=uniform` (BASELINE config #2) and
  `--model=resnet_at_cifar10 --learner=uniform --enbl_dst` on CIFAR-10 `.bin`
  files written by make_minimal_data, the teacher from a `full-prec` run;
  the `*_run.py` entry scripts;
* the KD loss against DistillationHelper.calc_loss on the same logits
  (1e-6 relative); the teacher restored from the port's own checkpoint,
  frozen, and run outside the student's policy: with it, a QAT step makes as
  many fake-quant calls as without it.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu_torch.config import FLAGS as TFLAGS

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_flags(monkeypatch):
    """Restore every flag of the port's registry after each test; the JSONL
    summaries spare the tests TensorBoard's imports."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _common(tmp_path, name):
    return ['--log_dir=%s' % (tmp_path / name / 'logs'),
            '--save_path=%s' % (tmp_path / name / 'models' / 'model.ckpt'),
            '--uql_save_quant_model_path=%s' % (tmp_path / name / 'uql' / 'model.ckpt'),
            '--compute_dtype=float32', '--summ_step=1', '--batch_size=8', '--batch_size_eval=8']


def _tags(tmp_path, name):
    with open(tmp_path / name / 'logs' / 'scalars.jsonl') as fin:
        return {json.loads(line)['tag'] for line in fin}


def test_default_model_runs_end_to_end(tmp_path):
    """No --model: ConvNet @ FMNIST (synthetic data), full-prec then uniform."""
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    if 'model' in TFLAGS:  # an earlier main() in this process left its choice
        TFLAGS.model = TFLAGS._specs['model'].default
    argv = _common(tmp_path, 'convnet') + ['--synthetic_data', '--nb_smpls_train=32',
                                           '--nb_smpls_eval=16', '--nb_epochs_rat=0.01']
    learner = port_main.main(argv, device='cpu')
    assert isinstance(learner.model_helper, ModelHelper) and TFLAGS.model == 'convnet_at_fmnist'
    learner = port_main.main(argv + ['--learner=uniform', '--nb_epochs_rat=0.5'], device='cpu')
    assert learner.statistics['weight_paths'] == ['conv2', 'fc3']
    assert {'train/loss', 'train/accuracy'} <= _tags(tmp_path, 'convnet')


def test_lenet_uniform_runs_through_its_entry_script(tmp_path):
    """BASELINE config #2: LeNet @ CIFAR-10 + uniform, restoring its baseline."""
    from pocketflow_tpu_torch.core import checkpoint as ckpt
    from pocketflow_tpu_torch.nets import lenet_at_cifar10_run
    argv = _common(tmp_path, 'lenet') + ['--synthetic_data', '--nb_smpls_train=32',
                                         '--nb_smpls_eval=16', '--nb_epochs_rat=0.01']
    lenet_at_cifar10_run.main(argv, device='cpu')
    learner = lenet_at_cifar10_run.main(argv + ['--learner=uniform', '--nb_epochs_rat=0.02',
                                                '--uql_weight_bits=2'], device='cpu')
    payload = ckpt.restore_latest(str(tmp_path / 'lenet' / 'uql' / 'model.ckpt'))
    assert payload['step'] == learner.finetune_steps == 4
    assert torch.equal(payload['extra']['w_bits'], torch.full((2,), 2.0))
    assert tuple(payload['model']['fc3.kernel'].shape) == (1600, 256)


@pytest.fixture
def cifar_dir(tmp_path):
    from pocketflow_tpu_torch.tools import make_minimal_data
    make_minimal_data.main(['--dst_dir=%s' % tmp_path, '--datasets=cifar10', '--nb_train=40',
                            '--nb_eval=8'])
    return tmp_path / 'cifar10'


def test_resnet20_uniform_with_distillation_on_cifar10_files(tmp_path, cifar_dir):
    """full-prec (the teacher), then uniform with --uql_activation_bits=8,
    without and with --enbl_dst, through resnet_at_cifar10_run."""
    from pocketflow_tpu_torch.nets import resnet_at_cifar10_run
    from pocketflow_tpu_torch.ops import fake_quant as fq
    argv = _common(tmp_path, 'r20') + ['--data_dir_local=%s' % cifar_dir, '--nb_smpls_train=40',
                                       '--nb_smpls_eval=8']
    teacher = resnet_at_cifar10_run.main(argv + ['--nb_epochs_rat=0.004'], device='cpu')
    assert teacher.dataset_train.nb_smpls_loaded == 40
    calls = {}
    for dst in ('--noenbl_dst', '--enbl_dst'):
        fq.reset_counters()
        learner = resnet_at_cifar10_run.main(
            argv + ['--learner=uniform', dst, '--uql_activation_bits=8', '--nb_epochs_rat=0.004'],
            device='cpu')
        calls[dst] = fq.counters()['plain']
        assert learner.statistics['nb_matmuls'] == 20 and learner.finetune_steps == 1
    assert (learner.helper_dst is not None) and not learner.helper_dst.model.training
    assert not any(p.requires_grad for p in learner.helper_dst.model.parameters())
    # one grouped weight call and 19 activation calls a forward, teacher or not
    assert calls['--enbl_dst'] == calls['--noenbl_dst'] > 0
    assert 'train/dst_loss' in _tags(tmp_path, 'r20')


def test_distillation_needs_a_teacher_checkpoint(tmp_path):
    from pocketflow_tpu_torch.learners.distillation_helper import DistillationHelper
    from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper
    with TFLAGS.scope(save_path=str(tmp_path / 'none' / 'model.ckpt'), synthetic_data=True):
        with pytest.raises(FileNotFoundError, match='full-prec checkpoint'):
            DistillationHelper(ModelHelper(), 'cpu')


@pytest.mark.parametrize('tempr,weight', [(4.0, 4.0), (1.0, 0.5), (10.0, 2.0)])
def test_kd_loss_matches_jax(tempr, weight):
    from pocketflow_tpu.config import FLAGS as JFLAGS
    from pocketflow_tpu.learners.distillation_helper import DistillationHelper as JDst
    from pocketflow_tpu_torch.learners.distillation_helper import DistillationHelper as TDst
    rng = np.random.default_rng(8)
    student = (rng.normal(size=(16, 10)) * 3).astype(np.float32)
    teacher = (rng.normal(size=(16, 10)) * 3).astype(np.float32)
    with JFLAGS.scope(tempr_dst=tempr, loss_w_dst=weight), \
            TFLAGS.scope(tempr_dst=tempr, loss_w_dst=weight):
        want = float(JDst.calc_loss(None, jnp.asarray(student), jnp.asarray(teacher)))
        got = TDst.calc_loss(torch.from_numpy(student), torch.from_numpy(teacher))
        # bf16 logits (the card's compute dtype) are taken in fp32
        from_bf16 = TDst.calc_loss(torch.from_numpy(student).to(torch.bfloat16),
                                   torch.from_numpy(teacher).to(torch.bfloat16))
    assert got.dtype == from_bf16.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
