"""Checkpoints that resume on any mesh: main.main trains full-prec ConvNet @
FMNIST on four gloo CPU ranks under --mesh_shape=data:2,model:2
--enbl_tensor_parallel (fc3's kernel and its momentum held as shards), once
under each --ckpt_backend, and the checkpoint resumes at world size 1 and
on two data-parallel ranks (a changed device count), where the restored
parameters, BN statistics, momentum and step equal the saved ones bit for
bit (the shards gathered); the same checkpoint resumes on the TP mesh it
was written on, each rank holding its columns again; and
core/checkpoint.restore_intersecting grafts every parameter of it into a
fresh model of each mesh (a shard its slice).

'msgpack' (the default; the JAX package's flag and name, the port's .pt):
the full state gathered over the model group, one file written by rank 0.
'orbax': torch.distributed.checkpoint.async_save into
<save_path>-<step>.dcp, each rank writing its own shards (fc3's kernel and
momentum under '.../shard<m>of2', written by the data rank 0 of each model
index), indexed once complete; then main.main --exec_mode=eval at world 1
reads it.  Every rank is joined with a 120 s timeout.
"""

import os

import numpy as np
import pytest
import torch

from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.tools import launch
from torch_dist_ranks import tp_restore

torch.set_num_threads(2)
TESTS = os.path.dirname(os.path.abspath(__file__))
BACKENDS = ['msgpack', 'orbax']
NB_STEPS = 3


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _flags(tmp_path, backend):
    # ConvNet's 160 epochs of 64 samples at a global batch of 16: NB_STEPS steps
    return dict(synthetic_data=True, batch_size=8, batch_size_eval=8, nb_smpls_train=64,
                nb_smpls_eval=32, compute_dtype='float32', lrn_rate_init=0.05,
                nb_epochs_rat=NB_STEPS * 16 / (64 * 160), ckpt_backend=backend,
                save_path=str(tmp_path / 'models' / 'model.ckpt'),
                log_dir=str(tmp_path / 'logs'))


def _argv(flags):
    argv = ['--model=convnet_at_fmnist', '--learner=full-prec']
    for key, value in flags.items():
        argv.append('--%s' % key if value is True else '--%s=%s' % (key, value))
    return argv


@pytest.fixture(scope='module', params=BACKENDS)
def saved(request, tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp('tp_' + request.param)
    flags = _flags(tmp_path, request.param)
    argv = _argv(dict(flags, mesh_shape='data:2,model:2', enbl_tensor_parallel=True))
    ranks = launch.spawn('torch_dist_ranks:tp_main_rank', 4, {'argv': argv},
                         work_dir=str(tmp_path / 'ranks'), paths=[TESTS])
    return dict(backend=request.param, flags=flags, ranks=ranks, tmp_path=tmp_path)


def _assert_equal(got, want):
    assert got['step'] == want['step'] == NB_STEPS
    assert got['model'].keys() == want['model'].keys()
    for key, value in want['model'].items():
        assert got['model'][key].dtype == value.dtype and np.array_equal(got['model'][key],
                                                                         value), key
    assert got['momentum'].keys() == want['momentum'].keys()
    for key, value in want['momentum'].items():
        assert np.array_equal(got['momentum'][key], value), key


def test_tp_ranks_save_one_state(saved):
    """The ranks' full states at the last save are equal, and the files:
    one .pt from rank 0, or the shards of every rank."""
    last = [r['saves'][-1] for r in saved['ranks']]
    for other in last[1:]:
        _assert_equal(other, last[0])
    files = sorted(os.listdir(os.path.dirname(saved['flags']['save_path'])))
    if saved['backend'] == 'msgpack':
        assert files == ['checkpoint.json', 'model.ckpt-%d.pt' % NB_STEPS]
        writes = [[w for w in r['writes'] if w.endswith('.pt.tmp')] for r in saved['ranks']]
        assert len(writes[0]) == 1 and not any(writes[1:])
    else:  # each rank wrote its shards
        assert files == ['checkpoint.json', 'model.ckpt-%d.dcp' % NB_STEPS]
        import torch.distributed.checkpoint as dcp
        path = os.path.join(os.path.dirname(saved['flags']['save_path']), files[1])
        keys = set(dcp.FileSystemReader(path).read_metadata().state_dict_metadata)
        assert {'model/fc3.kernel/shard0of2', 'model/fc3.kernel/shard1of2'} <= keys
        assert 'model/fc3.kernel' not in keys and 'model/fc4.kernel' in keys
        assert len([f for f in os.listdir(path) if f.endswith('.distcp')]) >= 2
        assert torch.load(os.path.join(path, 'meta.pt'), weights_only=True)['model_size'] == 2


def _assert_restored(got, saved):
    _assert_equal(got, saved['ranks'][0]['saves'][-1])
    count, nb_params, equal = got['intersecting']
    assert count == nb_params and equal  # restore_intersecting: every parameter, whole


def test_resume_at_world_one(saved):
    got = tp_restore(saved['flags'])
    _assert_restored(got, saved)
    assert got['fc3'] == ((3136, 1024), (3136, 1024), False)


def test_resume_on_two_data_ranks(saved, tmp_path):
    flags = dict(saved['flags'], mesh_shape='data:2')
    ranks = launch.spawn('torch_dist_ranks:tp_restore', 2, {'flags': flags},
                         work_dir=str(tmp_path / 'ranks'), paths=[TESTS])
    for got in ranks:
        _assert_restored(got, saved)
        assert got['fc3'] == ((3136, 1024), (3136, 1024), False)


def test_resume_on_the_tp_mesh(saved, tmp_path):
    flags = dict(saved['flags'], mesh_shape='data:1,model:2', enbl_tensor_parallel=True)
    ranks = launch.spawn('torch_dist_ranks:tp_restore', 2, {'flags': flags},
                         work_dir=str(tmp_path / 'ranks'), paths=[TESTS])
    for got in ranks:
        _assert_restored(got, saved)
        assert got['fc3'] == ((3136, 512), (3136, 512), True)


def test_orbax_saves_during_training_hold_the_state_at_each_save(tmp_path):
    """--ckpt_backend=orbax saving at every step on data:1,model:2: each
    step's directory, written while the next steps train in place, holds
    the state at its save bit for bit, and dcp.async_save is handed host
    copies, no storage of a live parameter, buffer or momentum."""
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    flags = dict(_flags(tmp_path, 'orbax'), save_step=1, batch_size=16)  # one data rank
    argv = _argv(dict(flags, mesh_shape='data:1,model:2', enbl_tensor_parallel=True))
    ranks = launch.spawn('torch_dist_ranks:tp_main_rank', 2, {'argv': argv},
                         work_dir=str(tmp_path / 'ranks'), paths=[TESTS])
    for rank in ranks:  # one save a step, then the loop's last
        assert [s['step'] for s in rank['saves']] == list(range(1, NB_STEPS + 1)) + [NB_STEPS]
        assert rank['shared'] == []
        _assert_equal(rank['saves'][-1], ranks[0]['saves'][-1])
    for want in ranks[0]['saves'][:NB_STEPS - 1]:
        payload = ckpt_lib._dcp_load('%s-%d.dcp' % (flags['save_path'], want['step']))
        got = {'step': payload['step'],
               'model': {k: v.numpy() for k, v in payload['model'].items()},
               'momentum': {i: b['momentum_buffer'].numpy()
                            for i, b in payload['optimizer']['state'].items()}}
        assert got['step'] == want['step']
        assert got['model'].keys() == want['model'].keys()
        for key, value in want['model'].items():
            assert np.array_equal(got['model'][key], value), (want['step'], key)
        assert got['momentum'].keys() == want['momentum'].keys()
        for key, value in want['momentum'].items():
            assert np.array_equal(got['momentum'][key], value), (want['step'], key)
        # the next step moved the parameters: the save is not the final state
        assert not np.array_equal(want['model']['fc3.kernel'],
                                  ranks[0]['saves'][-1]['model']['fc3.kernel'])


def test_main_evaluates_the_checkpoint_at_world_one(saved):
    from pocketflow_tpu_torch import main as port_main
    learner = port_main.main(_argv(dict(saved['flags'], exec_mode='eval')), device='cpu')
    assert learner.nb_workers == 1 and not learner.enbl_tp
