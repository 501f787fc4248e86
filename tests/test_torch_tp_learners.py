"""The compression learners under tensor parallelism beyond full-prec and
uniform (tests/test_torch_tp_step*.py), on gloo CPU ranks:

* weight-sparse: masking.prune_update at a refresh on data:1,model:2, where
  fc3's kernel is a shard: its mask comes from the full kernel's threshold
  (the backup gathered), equal to the one-rank prune_update (which
  tests/test_torch_weight_sparse.py holds to the JAX package's) bit for
  bit, with the full shapes and the overall ratio; then main.main trains
  the uniform protocol at 0.5 from a full-prec baseline on data:1,model:2
  (JAX's tests/test_tensor_parallel.py trains it on data:4,model:2): the
  ranks agree, the pruned fraction of the maskable weights is 0.5 within
  0.03 (JAX's bound), and the checkpoint (masks and backups of fc3 saved
  full) evaluates at world 1 to the same fraction;
* chn-pruned-gpu: two PGD steps and a reconstruction step on ResNet-50 @
  ILSVRC-12 (32x32, fp32, the learner's seeded state) on data:1,model:2,
  where the stage-3/4 kernels are shards: their per-input-channel norms and
  RMS sum over the model group, so the kernels (gathered), the channel
  masks and the losses equal one rank's steps on the full kernels (which
  tests/test_torch_cp_variants.py holds to the JAX package's), the kernels
  within rtol 1e-4 (the sums run in another order), the masks exactly.
Every rank is joined with a 120 s timeout.
"""

import os

import numpy as np
import pytest
import torch

from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.tools import launch

torch.set_num_threads(2)
TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def test_prune_update_takes_the_full_kernels_threshold(tmp_path):
    ranks = launch.spawn('torch_dist_ranks:tp_prune_update', 2,
                         {'mesh_shape': 'data:1,model:2', 'ratio': 0.5},
                         work_dir=str(tmp_path), paths=[TESTS])
    for out in ranks:
        full, tp = out['full'], out['tp']
        assert tp['shapes'] == full['shapes'] and (3136, 1024) in full['shapes']
        assert tp['masks'].keys() == full['masks'].keys()
        for name, mask in full['masks'].items():
            assert np.array_equal(tp['masks'][name], mask), name
        assert tp['ratio'] == full['ratio'] and 0.45 < full['ratio'] <= 0.5


def _argv(tmp_path, learner, *extra):
    return ['--model=convnet_at_fmnist', '--learner=%s' % learner, '--synthetic_data',
            '--batch_size=8', '--batch_size_eval=8', '--nb_smpls_train=128',
            '--nb_smpls_eval=32', '--compute_dtype=float32', '--nb_epochs_rat=0.02',
            '--lrn_rate_init=0.05', '--summ_step=1',
            '--log_dir=%s' % (tmp_path / 'logs'),
            '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt'),
            '--ws_save_path=%s' % (tmp_path / 'models_ws' / 'model.ckpt'), *extra]


def test_weight_sparse_trains_under_tensor_parallelism(tmp_path):
    from pocketflow_tpu_torch import main as port_main
    port_main.main(_argv(tmp_path, 'full-prec'), device='cpu')  # the baseline, world 1
    ws = ['--ws_prune_ratio=0.5', '--ws_prune_ratio_prtl=uniform', '--ws_mask_update_step=3',
          '--ws_iter_ratio_beg=0.0', '--ws_iter_ratio_end=0.5']
    ranks = launch.spawn('torch_dist_ranks:main_rank', 2,
                         {'argv': _argv(tmp_path, 'weight-sparse', *ws,
                                        '--mesh_shape=data:1,model:2',
                                        '--enbl_tensor_parallel')},
                         work_dir=str(tmp_path / 'ranks'), paths=[TESTS])
    evals = [r['eval'] for r in ranks]
    assert evals[0] == evals[1]
    assert evals[0]['pr_msk'] == pytest.approx(0.5, abs=0.03)
    payload = torch.load(tmp_path / 'models_ws' / sorted(
        f for f in os.listdir(tmp_path / 'models_ws') if f.endswith('.pt'))[-1],
        weights_only=True)
    assert payload['model']['fc3.kernel'].shape == (3136, 1024)
    for key in ('masks', 'bkups'):
        assert payload['extra'][key]['fc3.kernel'].shape == (3136, 1024)
    masked = payload['model']['fc3.kernel'][payload['extra']['masks']['fc3.kernel'] == 0]
    assert masked.numel() > 0 and bool((masked == 0).all())
    # the checkpoint evaluates at world 1 to the same fraction
    from pocketflow_tpu_torch.learners import abstract_learner
    seen = {}
    run_eval = abstract_learner.AbstractLearner.run_eval_loop

    def recorded(self, *args, **kwargs):
        seen.update(run_eval(self, *args, **kwargs))
        return seen
    abstract_learner.AbstractLearner.run_eval_loop = recorded
    try:
        port_main.main(_argv(tmp_path, 'weight-sparse', *ws, '--exec_mode=eval'), device='cpu')
    finally:
        abstract_learner.AbstractLearner.run_eval_loop = run_eval
    assert seen['pr_msk'] == pytest.approx(evals[0]['pr_msk'], abs=1e-6)


def test_cpg_steps_on_shards_equal_one_rank(tmp_path):
    from torch_dist_ranks import tp_cpg
    flags = dict(synthetic_data=True, batch_size=4, batch_size_eval=4, nb_smpls_train=64,
                 nb_smpls_eval=16, compute_dtype='float32', ilsvrc_image_size=32, rand_seed=0)
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper
    with TFLAGS.scope(**flags):
        images, labels = ModelHelper(resnet_size=50).dataset_train.synthesize_arrays(64)
    images, labels = images[:4], labels[:4]
    want = tp_cpg(flags, images, labels)
    ranks = launch.spawn('torch_dist_ranks:tp_cpg', 2,
                         {'flags': dict(flags, mesh_shape='data:1,model:2',
                                        enbl_tensor_parallel=True),
                          'images': images, 'labels': labels},
                         work_dir=str(tmp_path), paths=[TESTS])
    assert want['shards'] == [] and len(ranks[0]['shards']) > 10
    for got in ranks:
        assert got['shards'] == ranks[0]['shards']
        for name, mask in want['masks'].items():
            assert np.array_equal(got['masks'][name], mask), name
        assert 0 < sum(float((m == 0).sum()) for m in want['masks'].values())
        for name, kernel in want['kernels'].items():
            np.testing.assert_allclose(got['kernels'][name], kernel, rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        for a, b in zip(got['losses'], want['losses']):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
