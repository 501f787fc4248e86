"""Faster R-CNN-ResNet-50 by the reference's recipe, a warm start, on one GPU
(counterpart of experiments/frcnn_warmstart_resnet50.py):

1. train a ResNet-50 classifier on the 16-class synthetic ILSVRC-12 set
   (224x224, batch 32, lr 0.05) for `cls_steps` steps and save it;
2. graft it into the detector's backbone through ``ModelHelper.warm_start``
   (``restore_intersecting`` with the 'backbone/' prefix), and check that
   the backbone's stem kernel changed at the graft;
3. finetune the detector for `det_steps` steps on 256 synthetic-VOC samples
   at 64x64 (fp32, batch 16, lr 0.005, no weight decay) and score its
   full-set VOC mAP over 64 eval samples; the script asserts mAP > 0.3, as
   the JAX script does.

    python -m pocketflow_tpu_torch.experiments.frcnn_warmstart_resnet50 [cls_steps] [det_steps]

(400 and 5,000 by default.)  It runs on the card.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

from pocketflow_tpu_torch.experiments import frcnn_synthetic_map as fsm
from pocketflow_tpu_torch.experiments import require_cuda
from pocketflow_tpu_torch.experiments import synthetic_parity as sp

MIN_MAP = 0.3  # the JAX script's convergence assertion
GRAFT_PROBE = 'backbone.conv_init.kernel'  # the tensor JAX's script compares


def classifier_flags(workdir: str) -> dict:
    return dict(batch_size=32, nb_classes=16, nb_smpls_train=2048, nb_smpls_eval=256,
                nb_epochs_rat=0.15, lrn_rate_init=0.05, resnet_size=50,
                save_path=os.path.join(workdir, 'cls/model.ckpt'),
                log_dir=os.path.join(workdir, 'logs'), summ_step=10 ** 9, save_step=10 ** 9)


def detector_flags(workdir: str) -> dict:
    return dict(frcnn_backbone='resnet50', synthetic_data=True, batch_size=16,
                batch_size_eval=16, nb_smpls_train=256, nb_smpls_eval=64, nb_epochs_rat=15.0,
                lrn_rate_init=0.005, voc_image_size=64, nb_bboxs_max=8, loss_w_dcy=0.0,
                frcnn_nb_proposals=32, frcnn_nb_pre_nms=128, frcnn_roi_batch=32,
                compute_dtype='float32', save_path=os.path.join(workdir, 'cls/model.ckpt'),
                log_dir=os.path.join(workdir, 'logs'), summ_step=10 ** 9, save_step=10 ** 9)


def run(cls_steps: int = 400, det_steps: int = 5000, device='cuda', overrides=None,
        workdir=None) -> dict:
    """The three stages; returns {'mAP', 'steps', 'ms_per_step',
    'eval_seconds', 'cls_accuracy', 'cls_s', 'grafted', 'graft_max_abs'}.
    Raises if the graft left the backbone's stem kernel as it was."""
    import torch
    workdir = workdir or tempfile.mkdtemp(prefix='pf_frcnn_ws_')
    flags = sp.Flagged(overrides)
    flags.start({})  # the overrides, under both stages' flags
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner

    # 1. the classifier trunk on synthetic 16-class ILSVRC-12
    with flags.scope(**classifier_flags(workdir)):
        from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper as ClsHelper
        learner = FullPrecLearner(None, ClsHelper(resnet_size=50), device=device)
        state, tx, _ = learner.init_state()
        step = learner.build_train_step(tx)
        iterator = learner.dataset_train.build()
        start = time.perf_counter()
        metrics = {}
        for i in range(cls_steps):
            state, metrics = step(state, learner.put_batch(next(iterator)), learner.generator(i))
        cls_acc = float(metrics['accuracy']) if metrics else float('nan')
        cls_s = time.perf_counter() - start
        print('classifier: %d steps, final train acc %.3f (%.0fs)' % (cls_steps, cls_acc, cls_s),
              flush=True)
        cls_ckpt = FLAGS.save_path
        learner.save_model(state, cls_ckpt)
        del learner, state

    # 2. the graft
    flags.start(detector_flags(workdir))
    from pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc import ModelHelper
    helper = ModelHelper()
    learner = FullPrecLearner(None, helper, device=device)
    state, tx, _ = learner.init_state()
    probe = dict(state.model.named_parameters())[GRAFT_PROBE]
    before = probe.detach().float().cpu().clone()
    state = helper.warm_start(state)
    after = probe.detach().float().cpu()
    if torch.allclose(before, after):
        raise RuntimeError('warm start grafted nothing into %s from %s' % (GRAFT_PROBE, cls_ckpt))
    graft = float((after - before).abs().max())
    print('warm start: backbone grafted from %s (%s max |after - before| %.4g)'
          % (cls_ckpt, GRAFT_PROBE, graft), flush=True)

    # 3. the detector's finetune and its mAP
    state, _, train_s = fsm.train_detector(learner, state, tx, det_steps, seed=cls_steps)
    out = fsm.score(helper, state.model, det_steps, train_s)
    return {**out, 'cls_accuracy': round(cls_acc, 4), 'cls_s': round(cls_s, 1),
            'grafted': True, 'graft_max_abs': graft}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    require_cuda('frcnn_warmstart_resnet50')
    from pocketflow_tpu_torch.core.cuda_timing import card_line
    print('card: %s' % card_line(), flush=True)
    res = run(int(argv[0]) if argv else 400, int(argv[1]) if len(argv) > 1 else 5000)
    if not res['mAP'] > MIN_MAP:
        raise SystemExit('warm-started FRCNN-ResNet50 failed to converge: mAP %.4f <= %.1f'
                         % (res['mAP'], MIN_MAP))
    return res


if __name__ == '__main__':
    main()
