"""The SSD-VGG16 accuracy-parity strip on one GPU (counterpart of
experiments/detection_parity.py): full-set VOC mAP of a from-scratch
baseline on synthetic VOC and of each compressed point finetuned from it.

The recipe is the JAX strip's: 8,192 synthetic-VOC samples at 64x64, bf16,
batch 16, lr 0.04, wd 5e-4, 120 epochs with the classification-loss
warm-up (8192 * 120 / 16 = 61,440 steps); 256 eval samples, seed 0.  Each
point restores the baseline checkpoint and finetunes at half the schedule:

* weight-sparse@50% (uniform protocol) and uniform@8bit (channel buckets,
  its mAP scored through the policy forward the QAT eval uses) without the
  warm-up ramp;
* channel@60%preserve (LASSO, 30 batches x 10 points, 120 ISTA iterations)
  and chn-pruned-gpu@40% (400 PGD iterations a layer) with it.

The bands are the JAX strip's, copied verbatim; ``--check`` exits 1 if the
baseline leaves its window or a point's delta (baseline - point) leaves its
band or "improves" past the two-sided floor.

    python -m pocketflow_tpu_torch.experiments.detection_parity --check --publish
    python -m pocketflow_tpu_torch.experiments.detection_parity --quick
    python -m pocketflow_tpu_torch.experiments.detection_parity --only ws,uq --workdir DIR
    python -m pocketflow_tpu_torch.experiments.detection_parity --check-file FILE

``--only`` re-measures the named points ({baseline, ws, uq, channel, cpg})
against the baseline checkpoint already trained in ``--workdir`` and merges
them into the stored results; ``--jobs N`` runs the points after the
baseline side by side, N processes on the one card (the detectors are
host-bound), each recorded as if it had run in turn.  The strip runs on the card; results carry
'_card', '_commit' and '_seconds' as synthetic_parity.py's, and each
point's eval seconds by part ('_eval_seconds': forward, decode, host NMS,
VOC eval), its step count ('_steps') and the train loop's ms a step
('_ms_per_step': the learner's whole train call, its prune pass and its
checkpoint saves included, over its steps).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

from pocketflow_tpu_torch.experiments import require_cuda
from pocketflow_tpu_torch.experiments import synthetic_parity as sp

# the JAX strip's locked bands (its experiments/results/detection_parity.json:
# baseline 0.9326; WS -0.0235, UQ -0.0021, channel 0.011, CPG -0.0365)
BASELINE_BAND = (0.80, 1.00)
LOCKED_MAX_DELTA = {
    'weight-sparse@50%': 0.06,
    'uniform@8bit': 0.06,
    'channel@60%preserve': 0.10,
    'chn-pruned-gpu@40%': 0.10,
}
# two-sided: an "improvement" past the measured regularization effect
# (CPG -0.0365) plus noise, with ~2x margin, flags a baseline regression
LOCKED_MIN_DELTA = -0.09
POINTS = ('baseline', 'ws', 'uq', 'channel', 'cpg')
HEADER = 'DETECTION PARITY BAND VIOLATIONS:'


def check_results(results, baseline_band=BASELINE_BAND, locked=None,
                  min_delta=LOCKED_MIN_DELTA):
    """Return a list of band violations (empty == healthy); the JAX strip's
    messages (frcnn_compression_parity.py passes its own bands)."""
    locked = LOCKED_MAX_DELTA if locked is None else locked
    violations = []
    base = results.get('full-prec_mAP')
    if base is None:
        return ['full-prec baseline mAP missing from results']
    # quick mode trains a few hundred steps: only ask for a number
    quick = bool(results.get('_quick'))
    band = (0.0, 1.0) if quick else baseline_band
    if not band[0] <= base <= band[1]:
        violations.append('full-prec mAP %.4f outside band [%.2f, %.2f]' % (base, *band))
    for key, bound in locked.items():
        delta = results.get(key + '_delta')
        if delta is None:
            if not quick:
                violations.append('%s missing from results' % key)
            continue
        if delta > bound:
            violations.append('%s mAP delta %.4f exceeds locked band %.2f' % (key, delta, bound))
        if not quick and delta < min_delta:
            violations.append(
                '%s mAP delta %.4f "improves" past the two-sided floor %.2f '
                '— suspect a baseline/train-pipeline regression' % (key, delta, min_delta))
    return violations


def strip_flags(workdir: str, quick: bool) -> dict:
    """The strip's base flags (the JAX strip's)."""
    return dict(
        synthetic_data=True, compute_dtype='bfloat16', rand_seed=0,
        batch_size=16, batch_size_eval=16,
        nb_smpls_train=512 if quick else 8192,
        nb_smpls_eval=64 if quick else 256,
        voc_image_size=64, nb_bboxs_max=8,
        lrn_rate_init=0.04, loss_w_dcy=5e-4,
        summ_step=2000, save_step=10 ** 6,
        save_path=os.path.join(workdir, 'models/model.ckpt'),
        log_dir=os.path.join(workdir, 'logs'),
        nb_epochs_rat=0.05 if quick else 1.0)


class MapRecorder(sp.Recorder):
    """A strip's results: each point's mAP under '<point>_mAP' and its delta
    (sp.Recorder), and beside them its eval seconds by part, its steps and
    the train call's ms a step."""

    def __init__(self, results: dict):
        super().__init__(results, suffix='_mAP')
        for key in ('_eval_seconds', '_steps', '_ms_per_step'):
            results.setdefault(key, {})
        self._train_s = None  # the last train call's seconds, until it is scored

    def alone(self, key: str, m: float):
        """A baseline of its own beside the strip's (no delta)."""
        self.results[key + self.suffix] = float(m)
        self._timed(key)
        print(json.dumps({key + self.suffix: round(float(m), 4)}), flush=True)

    def train(self, learner):
        """`learner.train()`, timed; returns its state."""
        start = time.perf_counter()
        state = learner.train()
        self._train_s = time.perf_counter() - start
        return state

    def mean_ap(self, key: str, learner, state, policy=None) -> float:
        """VOC mAP of `state`'s model (under `policy`) over the whole eval
        set, with the eval's seconds by part and the train call's figures
        recorded under `key`."""
        helper = learner.model_helper
        timings: Dict[str, float] = {}
        result = helper.evaluate_map(state.model, helper.dataset_eval, policy=policy,
                                     timings=timings)
        self.results['_eval_seconds'][key] = {k: round(v, 2) for k, v in timings.items()}
        steps = int(state.step)
        self.results['_steps'][key] = steps
        if self._train_s is not None and steps:
            self.results['_ms_per_step'][key] = round(1e3 * self._train_s / steps, 2)
        self._train_s = None
        return float(result['mAP'])


class Point:
    """One compressed point of a strip: its short name (``--only``), its
    results key, its learner, its flags, and whether its mAP is scored
    through the learner's quantization policy (or, `alone`, a baseline of
    its own with no delta)."""

    def __init__(self, name: str, key: str, learner: str, flags: dict, policy: bool = False,
                 alone: bool = False):
        self.name, self.key, self.learner, self.flags = name, key, learner, flags
        self.policy, self.alone = policy, alone

    def run(self, flagged, make, rec: 'MapRecorder'):
        """Train the point's learner under its flags and record its mAP."""
        with flagged.scope(**self.flags):
            learner = make(self.learner)
            state = rec.train(learner)
            policy = learner._policy_fn()(state) if self.policy else None
            m = rec.mean_ap(self.key, learner, state, policy=policy)
            if self.alone:
                rec.alone(self.key, m)
            else:
                rec.record(self.key, m)


def strip_points(workdir: str, quick: bool):
    """The SSD strip's points, in its order: they finetune FROM the trained
    baseline at half the schedule, WS and UQ without the warm-up ramp
    (re-ramping a trained net un-trains it); the LASSO (reference sampling,
    30 batches x 10 points) and PGD (400 iterations a layer) points keep it
    and run in full runs only."""
    ft_rat = 0.05 if quick else 0.5
    points = [
        Point('ws', 'weight-sparse@50%', 'weight-sparse', dict(
            ws_prune_ratio=0.5, ws_prune_ratio_prtl='uniform', ws_mask_update_step=20,
            nb_epochs_rat=ft_rat, nb_iters_cls_wmup=1,
            ws_save_path=os.path.join(workdir, 'ws/model.ckpt'))),
        Point('uq', 'uniform@8bit', 'uniform', dict(
            uql_weight_bits=8, uql_use_buckets=True, uql_bucket_type='channel',
            uql_quant_epochs=30, uql_quantize_all_layers=False, nb_epochs_rat=ft_rat,
            nb_iters_cls_wmup=1,
            uql_save_quant_model_path=os.path.join(workdir, 'uql/model.ckpt')), policy=True)]
    if not quick:
        points += [
            Point('channel', 'channel@60%preserve', 'channel', dict(
                cp_prune_option='uniform', cp_uniform_preserve_ratio=0.6,
                cp_nb_batches=30, cp_nb_points_per_layer=10, cp_nb_iters_ft_ratio=1.0,
                cp_lasso_nb_iters=120, nb_epochs_rat=ft_rat,
                cp_channel_pruned_path=os.path.join(workdir, 'cp/model.ckpt'))),
            Point('cpg', 'chn-pruned-gpu@40%', 'chn-pruned-gpu', dict(
                cpg_prune_ratio=0.4, cpg_skip_ht_layers=True, cpg_nb_iters_layer=400,
                nb_epochs_rat=ft_rat, cpg_save_path=os.path.join(workdir, 'cpg/model.ckpt')))]
    return points


def learner_maker(device, helper_cls):
    """`make(name)`: the learner `name` over a new `helper_cls()` on `device`."""
    from pocketflow_tpu_torch.learners import create_learner
    return lambda name: create_learner(None, helper_cls(), learner_name=name, device=device)


def _ssd_helper():
    from pocketflow_tpu_torch.nets.vgg_at_pascalvoc import ModelHelper
    return ModelHelper()


def run_strip(workdir=None, quick=False, only=None, device='cuda', overrides=None,
              jobs: int = 1) -> dict:
    """The baseline and the four points (the baseline and WS, UQ with
    `quick`); `only`: a subset of POINTS, the rest skipped, the baseline
    restored from `workdir`'s checkpoint unless 'baseline' is in it; with
    `jobs` > 1 the points run side by side after the baseline
    (`run_apart`).  Returns the results dict."""
    workdir = workdir or tempfile.mkdtemp(prefix='pf_det_parity_')
    want = lambda key: only is None or key in only  # noqa: E731
    results = {'_quick': bool(quick)}
    flags = sp.Flagged(overrides)
    flags.start(strip_flags(workdir, quick))
    make = learner_maker(device, _ssd_helper)

    # 1. the full-precision baseline (its checkpoint feeds every point)
    rec = MapRecorder(results)
    learner = make('full-prec')
    if want('baseline'):
        state = rec.train(learner)
    else:
        state, restored = learner.restore_baseline(learner.init_state()[0])
        if not restored:
            raise FileNotFoundError('--only without a trained baseline checkpoint in '
                                    '--workdir %s' % workdir)
    rec.baseline(rec.mean_ap('full-prec', learner, state))
    del learner, state

    # 2.-5. WS, UQ (scored through the QAT eval's policy), channel, CPG
    points = [p for p in strip_points(workdir, quick) if want(p.name)]
    if jobs > 1:
        run_apart(__spec__.name, rec, points, workdir, jobs, quick)
    else:
        for point in points:
            point.run(flags, make, rec)
    return results


def run_point(name: str, workdir: str, out_path: str, quick: bool, points_fn, flags_fn,
              helper_cls, device='cuda', overrides=None) -> dict:
    """One point of a strip alone (a child of `run_apart`): train and score
    it against the baseline checkpoint in `workdir`, and write its record
    (no baseline, no delta) to `out_path`."""
    results = {}
    flags = sp.Flagged(overrides)
    flags.start(flags_fn(workdir, quick))
    rec = MapRecorder(results)
    point = next(p for p in points_fn(workdir, quick) if p.name == name)
    point.alone = True  # the delta is the parent's, from its baseline
    point.run(flags, learner_maker(device, helper_cls), rec)
    with open(out_path, 'w') as fout:
        json.dump(results, fout)
    return results


def run_apart(module: str, rec: 'MapRecorder', points, workdir: str, jobs: int, quick: bool):
    """Run `points` side by side, `jobs` at a time, each in a process of its
    own (``python -m <module> --point NAME --workdir DIR``: they share the
    card and only read the baseline checkpoint), then record each in the
    strip's order as if it had run here: its mAP, its delta from this run's
    baseline, its seconds (its process's wall time), eval seconds, steps and
    ms a step.  A point whose process fails is left out (``--check`` then
    reports it missing)."""
    running, pending, done = {}, list(points), {}
    while pending or running:
        while pending and len(running) < jobs:
            point = pending.pop(0)
            out = os.path.join(workdir, 'point_%s.json' % point.name)
            argv = [sys.executable, '-m', module, '--point', point.name, '--workdir', workdir,
                    '--point-out', out] + (['--quick'] if quick else [])
            running[point.name] = (subprocess.Popen(argv), out, time.perf_counter())
        time.sleep(1.0)
        for name, (proc, out, started) in list(running.items()):
            if proc.poll() is None:
                continue
            del running[name]
            if proc.returncode != 0:
                print('point %s: its process exited %d' % (name, proc.returncode), flush=True)
                continue
            with open(out) as fin:
                done[name] = (json.load(fin), time.perf_counter() - started)
    for point in points:
        if point.name in done:
            _merge_point(rec, point, *done[point.name])


def _merge_point(rec: 'MapRecorder', point, child: dict, seconds: float):
    m = child[point.key + rec.suffix]
    if point.alone:
        rec.alone(point.key, m)
    else:
        rec.record(point.key, m)
    rec.results['_seconds'][point.key] = round(seconds, 1)
    for record in ('_eval_seconds', '_steps', '_ms_per_step'):
        if point.key in child.get(record, {}):
            rec.results[record][point.key] = child[record][point.key]


def merge_stored(path: str, results: dict) -> dict:
    """`results` over the results stored at `path` (a subset re-measure
    against the same baseline checkpoint): the points it has replace the
    stored ones, and its per-point records join theirs."""
    if not os.path.exists(path):
        return results
    with open(path) as fin:
        merged = json.load(fin)
    for key, value in results.items():
        if isinstance(value, dict) and isinstance(merged.get(key), dict):
            merged[key].update(value)
        else:
            merged[key] = value
    return merged


def cli(argv, tag: str, description: str, run_fn, check_fn, healthy: str, header: str,
        extra_args=None, dispatch=None) -> dict:
    """The strips' shared CLI: --check-file, or a run on the card (--quick,
    --check, --publish) through `run_fn(args)`; `extra_args(parser)` adds a
    strip's own options and `dispatch(args)` may serve one of them instead
    (returning its result, or None to run the strip)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('--quick', action='store_true', help='a short smoke run')
    parser.add_argument('--check', action='store_true', help='exit 1 on a band violation')
    parser.add_argument('--check-file', help='only check the results in this JSON file')
    parser.add_argument('--publish', action='store_true',
                        help='write a full run to %s' % sp.RESULTS_DIR)
    if extra_args is not None:
        extra_args(parser)
    args = parser.parse_args(argv)
    if args.check_file:
        with open(args.check_file) as fin:
            data = json.load(fin)
        if sp.report(check_fn(data), header, healthy):
            sys.exit(1)
        return data
    require_cuda(tag)
    import torch
    from pocketflow_tpu_torch.core.cuda_timing import card_line
    card = card_line()
    print('card: %s | %s' % (card, torch.cuda.get_device_name(0)), flush=True)
    if dispatch is not None:
        served = dispatch(args, card)
        if served is not None:
            return served
    if args.publish and args.quick:
        print('NOTE: --publish is ignored under --quick (quick results never overwrite the '
              'committed evidence)', flush=True)
    publish = args.publish and not args.quick
    out = run_fn(args)
    if getattr(args, 'only', None):
        out = merge_stored(sp.result_path(tag, publish), out)
    sp.finish(out, tag, publish, card)
    print(json.dumps(out, indent=2), flush=True)
    if args.check and sp.report(check_fn(out), header, healthy):
        sys.exit(1)
    return out


def point_args(parser):
    """The options of the side-by-side mode (`run_apart`), shared by both
    strips."""
    parser.add_argument('--jobs', type=int, default=1,
                        help='run the points after the baseline side by side, JOBS at a time')
    parser.add_argument('--point', help='(run_apart\'s child) run this point alone against '
                        '--workdir\'s baseline checkpoint and write its record to --point-out')
    parser.add_argument('--point-out', help='(run_apart\'s child) where --point writes')


def main(argv=None) -> dict:
    def extra(parser):
        parser.add_argument('--only', help='comma-separated points of %s to re-measure against '
                            "--workdir's baseline checkpoint" % (POINTS,))
        parser.add_argument('--workdir', help='the strip\'s work directory (checkpoints)')
        point_args(parser)

    def dispatch(args, card):
        if args.point:
            return run_point(args.point, args.workdir, args.point_out, args.quick,
                             strip_points, strip_flags, _ssd_helper)
        return None

    def run(args):
        only = set(args.only.split(',')) if args.only else None
        if only and not only <= set(POINTS):
            raise SystemExit('--only takes points of %s, not %s' % (POINTS, sorted(only)))
        return run_strip(workdir=args.workdir, quick=args.quick, only=only, jobs=args.jobs)

    return cli(argv, 'detection_parity', __doc__.split('\n\n')[0], run, check_results,
               'detection parity bands: all %d points within locked bands'
               % len(LOCKED_MAX_DELTA), HEADER, extra, dispatch)


if __name__ == '__main__':
    main()
