"""Faster R-CNN on synthetic VOC from scratch on one GPU (counterpart of
experiments/frcnn_synthetic_map.py): the two-level detector trained for
`nb_steps` steps on 256 synthetic rectangle-detection samples at 64x64
(fp32, batch 16, 32 proposals from 128 before NMS, ROI batch 32, lr 0.02,
no weight decay), then scored by full-set VOC mAP over 64 eval samples.
The script asserts mAP > 0.3, as the JAX script does.

    python -m pocketflow_tpu_torch.experiments.frcnn_synthetic_map [nb_steps] [backbone]

(2,000 steps of the `resnet18` trunk by default.)  It runs on the card and
prints the losses every 200 steps, the mAP, and the train loop's ms a step
and the eval's seconds by part.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

from pocketflow_tpu_torch.experiments import require_cuda
from pocketflow_tpu_torch.experiments import synthetic_parity as sp

MIN_MAP = 0.3  # the JAX script's convergence assertion
LOG_EVERY = 200


def drill_flags(workdir: str) -> dict:
    """The JAX drill's flags."""
    return dict(synthetic_data=True, batch_size=16, batch_size_eval=16,
                nb_smpls_train=256, nb_smpls_eval=64, nb_epochs_rat=5.0,
                lrn_rate_init=0.02, voc_image_size=64, nb_bboxs_max=8,
                loss_w_dcy=0.0, frcnn_nb_proposals=32, frcnn_nb_pre_nms=128,
                frcnn_roi_batch=32, compute_dtype='float32',
                save_path=os.path.join(workdir, 'models/model.ckpt'),
                log_dir=os.path.join(workdir, 'logs'),
                summ_step=10 ** 9, save_step=10 ** 9)


def train_detector(learner, state, tx, nb_steps: int, seed: int, label: str = 'step') -> tuple:
    """`nb_steps` train steps of `learner` from `state` on its train set,
    the losses printed every LOG_EVERY steps; returns (state, the last
    metrics, seconds)."""
    import torch
    step = learner.build_train_step(tx)
    iterator = learner.dataset_train.build()
    start = time.perf_counter()
    metrics = {}
    for i in range(nb_steps):
        state, metrics = step(state, learner.put_batch(next(iterator)),
                              learner.generator(seed + i))
        if (i + 1) % LOG_EVERY == 0:
            print('%s %d: rpn %.3f rcnn %.3f acc %.3f (%.0fs)'
                  % (label, i + 1, float(metrics['rpn_loss']), float(metrics['rcnn_loss']),
                     float(metrics['accuracy']), time.perf_counter() - start), flush=True)
    if learner.device.type == 'cuda':
        torch.cuda.synchronize(learner.device)
    return state, metrics, time.perf_counter() - start


def score(helper, model, nb_steps: int, train_s: float) -> dict:
    """The full-set VOC mAP of `model` with the run's figures."""
    timings = {}
    res = helper.evaluate_map(model, helper.dataset_eval, timings=timings)
    out = {'mAP': round(float(res['mAP']), 4), 'steps': nb_steps,
           'ms_per_step': round(1e3 * train_s / max(nb_steps, 1), 2),
           'eval_seconds': {k: round(v, 2) for k, v in timings.items()}}
    print('mAP: %.4f' % res['mAP'], flush=True)
    print(json.dumps(out), flush=True)
    return out


def run(nb_steps: int = 2000, backbone: str = 'resnet18', device='cuda', overrides=None,
        workdir=None) -> dict:
    """Train `backbone`'s detector from scratch for `nb_steps` steps and
    score it; returns {'mAP', 'steps', 'ms_per_step', 'eval_seconds'}."""
    workdir = workdir or tempfile.mkdtemp(prefix='pf_frcnn_')
    flags = sp.Flagged(overrides)
    flags.start(dict(drill_flags(workdir), frcnn_backbone=backbone))
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
    from pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc import ModelHelper
    helper = ModelHelper()
    learner = FullPrecLearner(None, helper, device=device)
    state, tx, _ = learner.init_state()
    state, _, train_s = train_detector(learner, state, tx, nb_steps, seed=0)
    return score(helper, state.model, nb_steps, train_s)


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    require_cuda('frcnn_synthetic_map')
    from pocketflow_tpu_torch.core.cuda_timing import card_line
    print('card: %s' % card_line(), flush=True)
    res = run(int(argv[0]) if argv else 2000, argv[1] if len(argv) > 1 else 'resnet18')
    if not res['mAP'] > MIN_MAP:
        raise SystemExit('FRCNN failed to converge on synthetic VOC: mAP %.4f <= %.1f'
                         % (res['mAP'], MIN_MAP))
    return res


if __name__ == '__main__':
    main()
