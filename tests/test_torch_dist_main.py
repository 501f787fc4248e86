"""main.main on two gloo CPU ranks through pocketflow_tpu_torch/tools/launch.py
(each rank joined with a 120 s timeout), ConvNet @ FMNIST on synthetic data:

* the datasets' shards: rank r reads images[r::2] of the train and the eval
  set, with the seeds rand_seed + 977 r (+ 31337 for eval): its batches equal
  the JAX dataset's with shard_id/nb_shards set by hand (numpy loader), and
  the two shards are disjoint and cover the set (per-image checksums);
* a train run writes one checkpoint, from rank 0, and rank 1 writes nothing;
* the 2-rank eval of that checkpoint equals a 1-rank eval of it;
* distillation: both ranks restore the same teacher;
* a weight-sparsification search (optimal protocol, 2 roll-outs) whose
  rewards make rank 0 choose the first roll-out and rank 1 the last returns
  rank 0's ratios on both ranks;
* dryrun_multichip(2).
"""

import glob
import os

import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.tools import launch

torch.set_num_threads(2)
TESTS = os.path.dirname(os.path.abspath(__file__))
SHARD_FLAGS = dict(synthetic_data=True, nb_smpls_train=64, nb_smpls_eval=64, batch_size=8,
                   batch_size_eval=8, rand_seed=3)


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _spawn(target, kwargs, tmp_path, name):
    return launch.spawn('torch_dist_ranks:' + target, 2, kwargs,
                        work_dir=str(tmp_path / name), paths=[TESTS])


def _argv(tmp_path):
    return ['--model=convnet_at_fmnist', '--synthetic_data', '--batch_size=8',
            '--batch_size_eval=8', '--nb_smpls_train=64', '--nb_smpls_eval=32',
            '--compute_dtype=float32', '--summ_step=1', '--enbl_multi_gpu',
            '--log_dir=%s' % (tmp_path / 'logs'),
            '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt')]


def _jax_shard_batches(shard_id, nb_batches):
    """The JAX dataset's first batches of shard `shard_id` of 2 (train, eval)."""
    from pocketflow_tpu.nets.convnet_at_fmnist import ModelHelper
    out = {}
    with JFLAGS.scope(**SHARD_FLAGS, enbl_native_loader=False):
        helper = ModelHelper()
        for name, dataset in (('train', helper.build_dataset_train()),
                              ('eval', helper.build_dataset_eval())):
            dataset.shard_id, dataset.nb_shards = shard_id, 2
            dataset._rng = np.random.default_rng(FLAGS_SEED + 977 * shard_id
                                                 + (0 if name == 'train' else 31337))
            iterator = dataset.build()
            batches = [next(iterator) for _ in range(nb_batches)]
            out[name] = {k: np.concatenate([np.asarray(b[k]) for b in batches])
                         for k in ('image', 'label')}
    return out


FLAGS_SEED = SHARD_FLAGS['rand_seed']


def test_shards_are_disjoint_and_match_jax(tmp_path):
    # one pass over each rank's shard of 32 (synthetic sets hold at least 64): 4 batches
    # the NumPy iterator in both packages
    ranks = _spawn('dataset_batches', {'flags': dict(SHARD_FLAGS, enbl_native_loader=False),
                                       'nb_batches': 4}, tmp_path, 'data')
    for subset, size in (('train', 64), ('eval', 64)):
        shards = [set(r[subset]['sha1'][:size // 2]) for r in ranks]
        assert [r[subset]['shard'] for r in ranks] == [(0, 2), (1, 2)]
        assert len(shards[0]) == len(shards[1]) == size // 2  # one pass covers the shard
        assert not shards[0] & shards[1]
        assert ranks[0][subset]['loaded'] == size
    for rank, out in enumerate(ranks):
        want = _jax_shard_batches(rank, 4)
        for subset in ('train', 'eval'):
            assert np.array_equal(out[subset]['image'], want[subset]['image'])
            assert np.array_equal(out[subset]['label'], want[subset]['label'])


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """A full-prec train run on 2 ranks, then its eval on 2 ranks."""
    tmp_path = tmp_path_factory.mktemp('trained')
    argv = _argv(tmp_path) + ['--learner=full-prec', '--nb_epochs_rat=0.01']
    train = _spawn('main_rank', {'argv': argv}, tmp_path, 'train')
    evals = _spawn('main_rank', {'argv': argv + ['--exec_mode=eval']}, tmp_path, 'eval')
    return dict(tmp_path=tmp_path, argv=argv, train=train, evals=evals)


def test_one_checkpoint_from_rank_zero(trained):
    files = sorted(os.path.basename(p) for p in glob.glob(
        str(trained['tmp_path'] / 'models' / '*')))
    assert files == ['checkpoint.json', 'model.ckpt-6.pt']  # 6 steps
    writes = [[w for w in r['writes'] if w.endswith('.pt.tmp')] for r in trained['train']]
    assert len(writes[0]) == 1 and writes[1] == []


def test_two_rank_eval_equals_one_rank_eval(trained):
    from pocketflow_tpu_torch import main as port_main
    learner = port_main.main(trained['argv'] + ['--exec_mode=eval'], device='cpu')
    one = learner.evaluate()
    for rank in trained['evals']:
        assert set(rank['eval']) == set(one)
        for key, value in one.items():
            assert abs(rank['eval'][key] - value) <= 1e-6 * max(1.0, abs(value)), key
    # the train run's final evals agree across the ranks
    assert trained['train'][0]['eval'] == trained['train'][1]['eval']


def test_both_ranks_restore_the_same_teacher(trained, tmp_path):
    argv = trained['argv'] + ['--learner=uniform', '--enbl_dst', '--nb_epochs_rat=0.1',
                              '--uql_save_quant_model_path=%s' % (tmp_path / 'uql' / 'm.ckpt')]
    ranks = _spawn('main_rank', {'argv': argv}, tmp_path, 'dst')
    assert ranks[0]['teacher'] == ranks[1]['teacher']
    assert ranks[0]['eval'] == ranks[1]['eval']


def test_search_returns_rank_zeros_ratios_on_both_ranks(trained, tmp_path):
    argv = trained['argv'] + [
        '--learner=weight-sparse', '--ws_prune_ratio_prtl=optimal', '--ws_prune_ratio=0.5',
        '--nb_epochs_rat=0.05', '--ws_mask_update_step=2', '--ws_iter_ratio_end=0.3',
        '--ws_nb_rlouts=2', '--ws_nb_rlouts_min=1', '--ws_nb_iters_rg=1', '--ws_nb_iters_ft=1',
        '--ws_nb_iters_feval=1', '--ws_save_path=%s' % (tmp_path / 'ws' / 'model.ckpt')]
    ranks = _spawn('main_rank', {'argv': argv, 'poison_rewards': True}, tmp_path, 'ws')
    (before0, after0), = ranks[0]['ratios']
    (before1, after1), = ranks[1]['ratios']
    assert not np.array_equal(before0, before1)  # the poisoned rank chose otherwise
    assert np.array_equal(after0, before0) and np.array_equal(after1, before0)
    assert ranks[0]['pairs'] == ranks[1]['pairs']
    assert [r for _, r in ranks[0]['pairs']] == [float(r) for r in before0]
    # only rank 0 writes the search's state
    assert os.path.exists(tmp_path / 'ws' / 'ddpg_search.npz')


def test_dryrun_multichip(capsys):
    accuracy = launch.dryrun_multichip(2)
    assert 0.0 <= accuracy <= 1.0
    assert 'dryrun_multichip(2) OK: world=2' in capsys.readouterr().out
