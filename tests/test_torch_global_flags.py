"""The reference's global flags in the port (the fault 'unrecognized flag'
that `main.main(['--enbl_multi_gpu', ...])` ended in): each of the nine
flags the JAX registry defines and ignores, --mesh_shape,
--enbl_tensor_parallel, and the flags of the real-data path and the
profiler (--enbl_native_loader, --data_dir_hdfs, --data_cache_dir,
--data_stage_timeout, --enbl_profiler, --profiler_start_step,
--profiler_nb_steps), parsed by both packages' registries from the same
argv to the same value, with the same default and help; and through
main.main on the CPU, where a command with one of the reference's flags,
--data_dir_hdfs or --enbl_profiler trains to the same checkpoint, bit for
bit, as the command without it and evaluates it."""

import numpy as np
import pytest
import torch

import pocketflow_tpu  # noqa: F401  (registers the JAX package's flags)
import pocketflow_tpu.core.profiling  # noqa: F401
import pocketflow_tpu.datasets.remote_fs  # noqa: F401
from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu_torch import main as port_main
from pocketflow_tpu_torch.config import FLAGS as TFLAGS

port_main.register_flags()  # every flag below, in the port's registry

torch.set_num_threads(2)
# flag -> a value on the command line
GLOBAL_FLAGS = {
    'enbl_multi_gpu': '--enbl_multi_gpu',
    'debug': '--debug',
    'model_http_url': '--model_http_url=http://localhost:1/models',
    'save_path_eval': '--save_path_eval=./models_eval_x/model.ckpt',
    'data_hdfs_host': '--data_hdfs_host=localhost',
    'nb_threads': '--nb_threads=3',
    'buffer_size': '--buffer_size=64',
    'cycle_length': '--cycle_length=2',
    'nb_smpls_per_batch': '--nb_smpls_per_batch=16',
    'mesh_shape': '--mesh_shape=data:1',
    'enbl_tensor_parallel': '--enbl_tensor_parallel',
    # the real-data path and the profiler
    'enbl_native_loader': '--enbl_native_loader=False',
    'data_dir_hdfs': '--data_dir_hdfs=/datasets/fmnist',
    'data_cache_dir': '--data_cache_dir=./data_cache_x',
    'data_stage_timeout': '--data_stage_timeout=60',
    'enbl_profiler': '--enbl_profiler',
    'profiler_start_step': '--profiler_start_step=3',
    'profiler_nb_steps': '--profiler_nb_steps=2',
}
# run through main.main: the reference's global flags, and of the new ones
# the profiler's (the hook traces steps 10-14 of the run) and the remote
# directory, which a local disk ignores (the loader's flag switches to the
# NumPy iterator's stream; the others are read only when staging or tracing)
SAME_CHECKPOINT = list(GLOBAL_FLAGS)[:11] + ['data_dir_hdfs', 'enbl_profiler']


@pytest.fixture(autouse=True)
def _both_registries():
    with TFLAGS.scope(**TFLAGS.as_dict()), JFLAGS.scope(**JFLAGS.as_dict()):
        yield


@pytest.mark.parametrize('name', list(GLOBAL_FLAGS))
def test_flag_parses_as_in_jax(name):
    assert TFLAGS._specs[name].default == JFLAGS._specs[name].default
    assert TFLAGS._specs[name].help == JFLAGS._specs[name].help
    assert TFLAGS.parse_args([GLOBAL_FLAGS[name]]) == []
    assert JFLAGS.parse_args([GLOBAL_FLAGS[name]]) == []
    assert TFLAGS.get(name) == JFLAGS.get(name) != JFLAGS._specs[name].default


def _argv(tmp_path):
    return ['--model=convnet_at_fmnist', '--learner=full-prec', '--synthetic_data',
            '--batch_size=8', '--batch_size_eval=8', '--nb_smpls_train=32',
            '--nb_smpls_eval=16', '--nb_epochs_rat=0.5', '--compute_dtype=float32',
            '--summ_step=1', '--log_dir=%s' % (tmp_path / 'logs'),
            '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt')]


def _train(tmp_path, extra):
    """main.main's train run with `extra` flags: the parameters it saved."""
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    with TFLAGS.scope(**TFLAGS.as_dict()):
        port_main.main(_argv(tmp_path) + extra, device='cpu')
    payload = ckpt_lib.restore_latest(str(tmp_path / 'models' / 'model.ckpt'))
    return payload['model']


@pytest.fixture(scope='module')
def baseline(tmp_path_factory):
    with TFLAGS.scope(**TFLAGS.as_dict()):
        return _train(tmp_path_factory.mktemp('baseline'), [])


@pytest.mark.parametrize('name', SAME_CHECKPOINT)
def test_main_with_flag_behaves_as_without(name, baseline, tmp_path):
    from pocketflow_tpu_torch import main as port_main
    got = _train(tmp_path, [GLOBAL_FLAGS[name]])
    assert set(got) == set(baseline)
    assert all(torch.equal(got[k], baseline[k]) for k in got)
    # and evaluates the checkpoint (the command that ended in SystemExit)
    learner = port_main.main(_argv(tmp_path) + [GLOBAL_FLAGS[name], '--exec_mode=eval'],
                             device='cpu')
    assert np.isfinite(learner.run_eval_loop(
        learner.restore_model(learner.init_state()[0]), learner.build_eval_step())['loss'])
