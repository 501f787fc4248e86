"""The Faster R-CNN-ResNet-18 compression-parity strip on one GPU
(counterpart of experiments/frcnn_compression_parity.py): full-set VOC mAP
of a baseline on the hardened synthetic-VOC regime and of two compressed
points finetuned from it, and of a baseline on the `small` trunk.

The recipe is the JAX strip's: 8,192 samples at 64x64 under HARD_REGIME
(pixel noise 64, texture amplitude 58, smaller objects), fp32, batch 16,
32 proposals from 128 before NMS, ROI batch 32, lr 0.04, wd 1e-4, 25
epochs (8192 * 25 / 16 = 12,800 steps); 256 eval samples, seed 0.
weight-sparse@50% (uniform) and channel@60%preserve (LASSO, 30 batches x 10
points) restore the baseline checkpoint and finetune at half the schedule;
the small trunk trains its own baseline under the same regime.  The bands
are the JAX strip's, copied verbatim.

    python -m pocketflow_tpu_torch.experiments.frcnn_compression_parity --check --publish
    python -m pocketflow_tpu_torch.experiments.frcnn_compression_parity --quick
    python -m pocketflow_tpu_torch.experiments.frcnn_compression_parity --rerun-channel DIR
    python -m pocketflow_tpu_torch.experiments.frcnn_compression_parity --probe \
        [backbone] [flag=value ...]
    python -m pocketflow_tpu_torch.experiments.frcnn_compression_parity --check-file FILE

``--jobs N`` runs the points after the baseline side by side (as
detection_parity.py's); ``--rerun-channel DIR`` re-measures the channel
point against the baseline checkpoint of an earlier run's work directory
and merges it into the published results; ``--probe`` trains and scores a baseline alone (flag
overrides after the backbone, as the JAX script's).  Results carry what
detection_parity.py's carry.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from pocketflow_tpu_torch.experiments import detection_parity as dp
from pocketflow_tpu_torch.experiments import synthetic_parity as sp

TAG = 'frcnn_compression_parity'
RESULTS = os.path.join(sp.RESULTS_DIR, TAG + '.json')

# the JAX strip's locked bands (its experiments/results/
# frcnn_compression_parity.json: baseline 0.8786, WS -0.0278, channel 0.0915)
BASELINE_BAND = (0.55, 0.97)
LOCKED_MAX_DELTA = {
    'weight-sparse@50%': 0.08,
    'channel@60%preserve': 0.12,
}
LOCKED_MIN_DELTA = -0.09
# the hardened regime: weaker texture, pixel noise and smaller objects keep a
# ResNet-18 baseline below saturation (the JAX strip's calibration)
HARD_REGIME = dict(synthetic_det_noise=64.0, synthetic_det_amp=58.0,
                   synthetic_det_min_div=6, synthetic_det_max_div=3)
POINTS = ('baseline', 'ws', 'channel', 'small')
HEADER = 'FRCNN PARITY BAND VIOLATIONS:'


def check_results(results):
    return dp.check_results(results, BASELINE_BAND, LOCKED_MAX_DELTA, LOCKED_MIN_DELTA)


def base_flags(workdir: str, quick: bool) -> dict:
    """The strip's base flags (the JAX strip's)."""
    return dict(
        synthetic_data=True, compute_dtype='float32', rand_seed=0,
        batch_size=16, batch_size_eval=16,
        nb_smpls_train=512 if quick else 8192,
        nb_smpls_eval=64 if quick else 256,
        voc_image_size=64, nb_bboxs_max=8,
        frcnn_backbone='resnet18', frcnn_nb_proposals=32,
        frcnn_nb_pre_nms=128, frcnn_roi_batch=32,
        lrn_rate_init=0.04, loss_w_dcy=1e-4,
        summ_step=1000, save_step=10 ** 6,
        save_path=os.path.join(workdir, 'models/model.ckpt'),
        log_dir=os.path.join(workdir, 'logs'),
        nb_epochs_rat=0.02 if quick else 1.0,
        **HARD_REGIME)


def channel_point_flags(workdir: str, ft_rat: float) -> dict:
    # the reference's sampling (30 batches x 10 points): at the smoke's 4x8
    # the per-layer regression is under-determined and the JAX strip lost
    # 0.20 mAP to it
    return dict(cp_prune_option='uniform', cp_uniform_preserve_ratio=0.6,
                cp_nb_batches=30, cp_nb_points_per_layer=10,
                cp_nb_iters_ft_ratio=1.0, cp_lasso_nb_iters=120,
                nb_epochs_rat=ft_rat,
                cp_channel_pruned_path=os.path.join(workdir, 'cp/model.ckpt'))


def strip_points(workdir: str, quick: bool):
    """The strip's points in its order: WS@50% and channel@60% finetune from
    the ResNet-18 baseline at half the schedule; the backbone-inversion
    probe trains the small trunk's own baseline under the same regime (full
    runs only)."""
    ft_rat = 0.02 if quick else 0.5
    points = [
        dp.Point('ws', 'weight-sparse@50%', 'weight-sparse', dict(
            ws_prune_ratio=0.5, ws_prune_ratio_prtl='uniform', ws_mask_update_step=20,
            nb_epochs_rat=ft_rat, ws_save_path=os.path.join(workdir, 'ws/model.ckpt'))),
        dp.Point('channel', 'channel@60%preserve', 'channel',
                 channel_point_flags(workdir, ft_rat))]
    if not quick:
        points.append(dp.Point('small', 'small-trunk', 'full-prec', dict(
            frcnn_backbone='small', save_path=os.path.join(workdir, 'small/model.ckpt')),
            alone=True))
    return points


def _helper():
    from pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc import ModelHelper
    return ModelHelper()


def run_strip(workdir=None, quick=False, device='cuda', overrides=None, points=None,
              jobs: int = 1) -> dict:
    """The ResNet-18 baseline, WS@50%, channel@60% and the small trunk (not
    with `quick`); `points`: a subset of POINTS (the baseline always runs);
    with `jobs` > 1 the points run side by side after the baseline
    (detection_parity.run_apart).  Returns the results dict."""
    workdir = workdir or tempfile.mkdtemp(prefix='pf_frcnn_parity_')
    results = {'_quick': bool(quick)}
    flags = sp.Flagged(overrides)
    flags.start(base_flags(workdir, quick))
    make = dp.learner_maker(device, _helper)

    # 1. the ResNet-18 baseline (its checkpoint feeds the points)
    rec = dp.MapRecorder(results)
    start = time.perf_counter()
    learner = make('full-prec')
    state = rec.train(learner)
    rec.baseline(rec.mean_ap('full-prec', learner, state))
    results['baseline_train_s'] = round(time.perf_counter() - start, 1)
    del learner, state

    # 2.-4. WS, channel, the small trunk
    todo = [p for p in strip_points(workdir, quick) if points is None or p.name in points]
    if jobs > 1:
        dp.run_apart(__spec__.name, rec, todo, workdir, jobs, quick)
    else:
        for point in todo:
            point.run(flags, make, rec)
    return results


def rerun_channel_point(workdir: str, card, device='cuda', overrides=None) -> dict:
    """Re-measure only the channel point against the baseline checkpoint in
    `workdir` (an earlier full run's) and merge it into the published
    results; exits 1 on a band violation."""
    flags = sp.Flagged(overrides)
    flags.start(base_flags(workdir, quick=False))
    with open(RESULTS) as fin:
        results = json.load(fin)
    rec = dp.MapRecorder(results)
    channel = next(p for p in strip_points(workdir, False) if p.name == 'channel')
    channel.run(flags, dp.learner_maker(device, _helper), rec)
    sp.finish(results, TAG, True, card)
    if sp.report(check_results(results), HEADER, _healthy()):
        raise SystemExit(1)
    return results


def run_probe(backbone: str, overrides=None, device='cuda') -> dict:
    """A baseline alone at the strip's flags, `overrides` on top (the
    difficulty knobs' calibration: ``--probe resnet18 synthetic_det_noise=60
    nb_epochs_rat=0.5``); prints and returns its mAP, steps, wall seconds
    and the train call's ms a step."""
    workdir = tempfile.mkdtemp(prefix='pf_frcnn_probe_')
    flags = sp.Flagged()
    flags.start(dict(base_flags(workdir, quick=False), frcnn_backbone=backbone,
                     **(overrides or {})))
    results = {}
    rec = dp.MapRecorder(results)
    start = time.perf_counter()
    learner = dp.learner_maker(device, _helper)('full-prec')
    state = rec.train(learner)
    m = rec.mean_ap('probe', learner, state)
    out = {'backbone': backbone, 'mAP': round(m, 4),
           'wall_s': round(time.perf_counter() - start, 1), 'steps': results['_steps']['probe'],
           'ms_per_step': results['_ms_per_step'].get('probe'),
           'eval_seconds': results['_eval_seconds']['probe']}
    print(json.dumps(out), flush=True)
    return out


def parse_probe(rest):
    """`--probe`'s arguments: an optional backbone, then flag=value pairs
    (ints, else floats), as the JAX script reads them."""
    backbone = rest[0] if rest and '=' not in rest[0] else 'resnet18'
    overrides = {}
    for tok in rest:
        if '=' in tok:
            key, value = tok.split('=', 1)
            try:
                overrides[key] = int(value)
            except ValueError:
                overrides[key] = float(value)
    return backbone, overrides


def _healthy() -> str:
    return 'frcnn parity bands: all %d points within locked bands' % len(LOCKED_MAX_DELTA)


def main(argv=None) -> dict:
    def extra(parser):
        parser.add_argument('--rerun-channel', metavar='DIR',
                            help='re-measure the channel point against DIR\'s baseline')
        parser.add_argument('--probe', nargs='*', metavar='ARG',
                            help='a baseline alone: [backbone] [flag=value ...]')
        parser.add_argument('--workdir', help='(run_apart\'s child) the strip\'s work '
                            'directory')
        dp.point_args(parser)

    def dispatch(args, card):
        if args.point:
            return dp.run_point(args.point, args.workdir, args.point_out, args.quick,
                                strip_points, base_flags, _helper)
        if args.rerun_channel:
            return rerun_channel_point(args.rerun_channel, card)
        if args.probe is not None:
            return run_probe(*parse_probe(args.probe))
        return None

    return dp.cli(argv, TAG, __doc__.split('\n\n')[0],
                  lambda args: run_strip(quick=args.quick, jobs=args.jobs), check_results,
                  _healthy(), HEADER, extra, dispatch)


if __name__ == '__main__':
    main()
