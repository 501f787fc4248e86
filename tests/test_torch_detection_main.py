"""The detectors through main.main on the CPU:

* vgg_at_pascalvoc: full-prec train, then eval reporting mAP and the
  per-class APs; uniform from that baseline (the first and last kernels
  left out), then its eval with mAP;
* BASELINE config #5 at CPU size: faster_rcnn_at_pascalvoc (`small` trunk)
  full-prec on two gloo ranks, then the channel learner's pipeline from it
  on two ranks (tests/torch_dist_ranks.py:detection_rank): pruned input
  channels zero in mid-trunk kernels and equal on both ranks, one
  checkpoint from rank 0, the 2-rank eval's mAP equal on both ranks and to a
  1-rank eval of the same checkpoint, the gathered detections equal to that
  rank's, image by image.
"""

import os

import numpy as np
import pytest
import torch

import torch_dist_ranks
from pocketflow_tpu_torch.config import FLAGS as TFLAGS

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _vgg_argv(tmp_path):
    return ['--model=vgg_at_pascalvoc', '--voc_image_size=32', '--batch_size=2',
            '--batch_size_eval=4', '--nb_smpls_train=64', '--nb_smpls_eval=8',
            '--nb_bboxs_max=6', '--compute_dtype=float32', '--nb_epochs_rat=0.001',
            '--ssd_score_threshold=0.04',
            '--log_dir=%s' % (tmp_path / 'logs'),
            '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt'),
            '--uql_save_quant_model_path=%s' % (tmp_path / 'uql' / 'model.ckpt')]


def _recorded_maps(monkeypatch):
    from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner
    maps = []
    eval_map = AbstractLearner.eval_map

    def recorded(self, *args, **kwargs):
        maps.append(eval_map(self, *args, **kwargs))
        return maps[-1]
    monkeypatch.setattr(AbstractLearner, 'eval_map', recorded)
    return maps


def test_main_vgg_full_prec_then_uniform(tmp_path, monkeypatch):
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.core import checkpoint as ckpt
    from pocketflow_tpu_torch.ops import fake_quant as fq
    maps = _recorded_maps(monkeypatch)
    argv = _vgg_argv(tmp_path)
    learner = port_main.main(argv + ['--learner=full-prec'], device='cpu')
    assert learner.nb_iters_train == 3  # int(64 * 120 * 1e-3 / 2)
    assert ckpt.latest_checkpoint(str(tmp_path / 'models')).endswith('model.ckpt-3.pt')
    port_main.main(argv + ['--learner=full-prec', '--exec_mode=eval'], device='cpu')
    assert len(maps) == 1 and 'mAP' in maps[0] and 0.0 <= maps[0]['mAP'] <= 1.0
    assert all(k == 'mAP' or k.startswith('ap_cls_') for k in maps[0])
    fq.reset_counters()
    learner = port_main.main(argv + ['--learner=uniform', '--uql_weight_bits=4', '--exec_mode=train'],
                             device='cpu')
    stats = learner.statistics
    assert stats['weight_paths'][0] == 'vgg/conv1_2' and stats['weight_paths'][-1] == 'cls_head_2'
    assert fq.counters()['plain'] >= 2
    port_main.main(argv + ['--learner=uniform', '--exec_mode=eval'], device='cpu')
    assert len(maps) == 2 and 'mAP' in maps[1]


def test_main_frcnn_channel_on_two_ranks(tmp_path, monkeypatch):
    """BASELINE config #5 at CPU size: Faster R-CNN (small) full-prec on two
    gloo ranks, then the channel learner's pipeline from it (baseline
    restore, LASSO selection, reconstruction, finetune) on two ranks: pruned
    input channels zero in mid-trunk kernels and equal on both ranks, one
    checkpoint from rank 0, and the 2-rank eval's mAP (the ranks'
    detections gathered) equal on both and to a 1-rank eval of the same
    checkpoint over the same set."""
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.tools import launch
    tests = os.path.dirname(os.path.abspath(__file__))
    argv = ['--model=faster_rcnn_at_pascalvoc', '--frcnn_backbone=small', '--voc_image_size=64',
            '--batch_size=2', '--batch_size_eval=8', '--nb_smpls_train=64', '--nb_smpls_eval=8',
            '--nb_bboxs_max=4', '--compute_dtype=float32', '--nb_epochs_rat=0.005',
            '--lrn_rate_init=0.01', '--loss_w_dcy=0.0', '--frcnn_nb_proposals=8',
            '--frcnn_nb_pre_nms=32', '--frcnn_roi_batch=8', '--frcnn_score_threshold=0.0',
            '--enbl_multi_gpu', '--log_dir=%s' % (tmp_path / 'logs'),
            '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt')]
    cp = ['--learner=channel', '--cp_prune_option=uniform', '--cp_uniform_preserve_ratio=0.5',
          '--cp_nb_batches=1', '--cp_nb_points_per_layer=2', '--cp_lasso_nb_iters=8',
          '--cp_nb_iters_ft_ratio=0.5', '--cp_channel_pruned_path=%s' % (tmp_path / 'cp' / 'm.ckpt')]

    def spawn(extra, name):
        return launch.spawn('torch_dist_ranks:detection_rank', 2, {'argv': argv + extra},
                            work_dir=str(tmp_path / ('ranks_' + name)), paths=[tests])
    spawn(['--learner=full-prec'], 'base')
    train = spawn(cp, 'cp')
    evals = spawn(cp + ['--exec_mode=eval'], 'eval')
    zeros = [r['zeros'][-1] for r in train]
    assert sorted(zeros[0]) == sorted(zeros[1])
    for name in zeros[0]:
        np.testing.assert_array_equal(zeros[0][name], zeros[1][name])
    mid = [n for n in zeros[0] if n.startswith('backbone/block') and zeros[0][n].any()]
    assert mid, 'no mid-trunk input channel was pruned'
    writes = [[w for w in r['writes'] if w.endswith('.pt.tmp') and '/cp/' in w] for r in train]
    assert len(writes[0]) == 1 and writes[1] == []
    assert len(os.listdir(tmp_path / 'cp')) == 2  # the checkpoint and its index
    maps = [r['maps'][-1] for r in evals]
    assert maps[0] == maps[1] and 'mAP' in maps[0]
    assert evals[0]['detections'] == evals[1]['detections']
    one = _recorded_maps(monkeypatch)
    learner = port_main.main([a for a in argv if a != '--enbl_multi_gpu'] + cp
                             + ['--exec_mode=eval'], device='cpu')
    assert one[-1] == maps[0]
    # the gathered set is the 1-rank set: the same detections, image by image
    dets, gts = torch_dist_ranks.detection_list(learner.model_helper)
    assert (dets, gts) == evals[0]['detections'] and len(dets) == 64 and sum(map(len, dets))
