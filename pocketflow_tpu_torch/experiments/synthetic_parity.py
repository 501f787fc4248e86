"""Accuracy-parity sweep on one GPU: every learner on ResNet-20 over the
non-saturating hard synthetic task (noisy template classification,
--synthetic_task=hard), and the MobileNet-v1 strip (counterpart of
experiments/synthetic_parity.py).

The task is made from a seed, so no data is read.  The full-precision
baseline lands mid-range (~0.80 at snr 0.18), so a compression fault shows
as an accuracy delta.  The operating points are the JAX harness's: WS
sparsity 50/75/90/95%, UQ/NUQ at 4 and 8 bits, uniform-tf 8/8, the four
channel-pruning families at 50%.  Each point runs through the learner's
public API at the JAX harness's flags and is evaluated by the JAX harness's
eval builder.  The bands below are the JAX harness's, copied verbatim:
``--check`` exits nonzero if the baseline leaves its window or any point's
delta (baseline - point) leaves its band.

    python -m pocketflow_tpu_torch.experiments.synthetic_parity --check [--publish]
    python -m pocketflow_tpu_torch.experiments.synthetic_parity --family mobilenet_v1 --check
    python -m pocketflow_tpu_torch.experiments.synthetic_parity --quick
    python -m pocketflow_tpu_torch.experiments.synthetic_parity --check-file FILE
    python -m pocketflow_tpu_torch.experiments.synthetic_parity --family mobilenet_v1 \
        --baseline-seeds 0-7 [--publish]

The sweep runs on the card (``require_cuda``).  Results go to
$PF_PARITY_OUT (default: pf_parity_results under the system's temporary
directory); a full (not --quick) ``--publish`` run writes them to
pocketflow_tpu_torch/experiments/results/ instead.  Each result carries the
card's name and power limit ('_card'), the commit ('_commit': $PF_COMMIT,
else ``git rev-parse HEAD``, else null) and each point's wall seconds
('_seconds').
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from pocketflow_tpu_torch.experiments import require_cuda

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'results')

# calibrated on-chip by the JAX harness (experiments/parity_calibrate.py):
# full-prec ResNet-20 eval accuracy vs snr: 0.10->0.25, 0.15->0.63,
# 0.18->0.802/0.805 (seeds 0/1), 0.20->0.857/0.858, 0.22->0.90, 0.30->0.975.
HARD_TASK_SNR = 0.18

# Locked regression bands: baseline absolute-accuracy window + per-point max
# accuracy delta vs the run's own baseline (the JAX harness's, from its
# experiments/results/parity_hard.json; margins ~2x the measured delta + the
# +-0.003 seed noise, floor 0.04).
BASELINE_BAND = (0.75, 0.88)
LOCKED_MAX_DELTA = {
    'weight-sparse@50%': 0.05,    # JAX measured 0.0034
    'weight-sparse@75%': 0.05,    # JAX measured 0.0015
    'weight-sparse@90%': 0.10,    # JAX measured 0.0254
    'weight-sparse@95%': 0.28,    # JAX measured 0.1938 (capacity point)
    'uniform@4bit': 0.06,         # JAX measured 0.0029
    'uniform@8bit': 0.04,         # JAX measured -0.0010
    'uniform-tf@8/8': 0.06,       # JAX measured 0.0020
    'non-uniform@4bit': 0.08,     # JAX measured 0.0151
    'non-uniform@8bit': 0.04,     # JAX measured -0.0005
    'chn-pruned-gpu@50%': 0.14,   # JAX measured 0.0625
    'channel@50%': 0.14,          # JAX measured 0.1055 (the constant-1e-4 finetune)
    'channel@50%+sched': 0.12,    # JAX measured -0.0278
    'chn-pruned-rmt@50%': 0.06,   # JAX measured -0.0195
    'dis-chn-pruned@50%': 0.12,   # JAX measured 0.0415
}

# MobileNet-v1 strip: depth multiplier 0.5 at 96x96 over 16k samples (the
# full-width net memorizes the set and never generalizes); its snr
# calibrated by the JAX harness (eval 0.085 / 0.135 / 0.893 at snr 0.06 /
# 0.10 / 0.15)
MOBILENET_SNR = 0.15
BASELINE_BAND_MOBILENET = (0.84, 0.95)  # JAX measured 0.8926
LOCKED_MAX_DELTA_MOBILENET = {
    'weight-sparse@50%': 0.06,    # JAX measured +0.0039
    'weight-sparse@90%': 0.12,    # JAX measured -0.0503
    'uniform-tf@8/8': 0.04,       # JAX measured -0.0068
    'chn-pruned-gpu@50%': 0.10,   # JAX measured -0.0425
    'channel@50%': 0.10,          # JAX measured +0.0293
    'channel@50%+sched': 0.10,    # JAX measured -0.0479
}

# Two-sided floors: masking and shrinkage regularize on a small task, so
# some points beat the baseline; an "improvement" far past the measured
# regularization effect (resnet20: cpg -0.0288; mobilenet: ws@90% -0.0503)
# means the baseline or the train pipeline regressed.
LOCKED_MIN_DELTA_FAMILY = {'resnet20': -0.09, 'mobilenet_v1': -0.10}


def _bands_for(family):
    if family == 'mobilenet_v1':
        return BASELINE_BAND_MOBILENET, LOCKED_MAX_DELTA_MOBILENET
    return BASELINE_BAND, LOCKED_MAX_DELTA


def check_results(results, family='resnet20'):
    """Return a list of human-readable band violations (empty == healthy)."""
    violations = []
    baseline_band, locked = _bands_for(family)
    min_delta = LOCKED_MIN_DELTA_FAMILY.get(family, -0.10)
    base = results.get('full-prec')
    if base is None:
        return ['full-prec baseline missing from results']
    if not baseline_band[0] <= base <= baseline_band[1]:
        violations.append('full-prec %.4f outside calibrated band [%.2f, %.2f]'
                          % (base, *baseline_band))
    for key, bound in locked.items():
        delta = results.get(key + '_delta')
        if delta is None:
            if not results.get('_quick'):
                violations.append('%s missing from results' % key)
            continue
        if delta > bound:
            violations.append('%s delta %.4f exceeds locked band %.2f'
                              % (key, delta, bound))
        if not results.get('_quick') and delta < min_delta:
            violations.append(
                '%s delta %.4f "improves" past the two-sided floor %.2f '
                '— suspect a baseline/train-pipeline regression'
                % (key, delta, min_delta))
    return violations


# ---------------------------------------------------------------------------
# the regimes
# ---------------------------------------------------------------------------

def resnet20_flags(workdir: str, nb_epochs_rat: float, nb_smpls_train: int = 4096) -> dict:
    """The ResNet-20 strip's base flags (the JAX harness's)."""
    return dict(
        synthetic_data=True, synthetic_task='hard',
        synthetic_snr=HARD_TASK_SNR, nb_classes=64,
        compute_dtype='bfloat16', rand_seed=0,
        batch_size=128, batch_size_eval=128, nb_smpls_train=nb_smpls_train,
        nb_smpls_eval=2048, lrn_rate_init=0.1, summ_step=400, save_step=10 ** 6,
        save_path=os.path.join(workdir, 'models/model.ckpt'),
        log_dir=os.path.join(workdir, 'logs'),
        resnet_size=20, nb_epochs_rat=nb_epochs_rat)


def mobilenet_flags(workdir: str, nb_epochs_rat: float) -> dict:
    """The MobileNet-v1 strip's base flags (the JAX harness's)."""
    return dict(
        synthetic_data=True, synthetic_task='hard',
        synthetic_snr=MOBILENET_SNR, nb_classes=64,
        compute_dtype='bfloat16', rand_seed=0,
        batch_size=128, batch_size_eval=128, ilsvrc_image_size=96,
        mobilenet_depth_mult=0.5,
        nb_smpls_train=16384, nb_smpls_eval=2048,
        lrn_rate_init=0.1, summ_step=400, save_step=10 ** 6,
        save_path=os.path.join(workdir, 'models/model.ckpt'),
        log_dir=os.path.join(workdir, 'logs'),
        mobilenet_version=1, nb_epochs_rat=nb_epochs_rat)


class Flagged:
    """The port's flags for one sweep: ``start(base)`` sets the base flags
    permanently, as the JAX harness does, and ``scope(**point)`` a point's;
    `overrides` replace base and point flags of the same name (tiny runs on
    the CPU; an empty dict in every real run)."""

    def __init__(self, overrides: Optional[dict] = None):
        from pocketflow_tpu_torch.main import register_flags
        register_flags()  # every learner's flags, before any is set
        self.overrides = dict(overrides or {})

    def start(self, base: dict):
        from pocketflow_tpu_torch.config import FLAGS
        FLAGS.override(**{**base, **self.overrides})

    def scope(self, **point):
        from pocketflow_tpu_torch.config import FLAGS
        return FLAGS.scope(**{**point, **{k: v for k, v in self.overrides.items()
                                          if k in point}})


class Recorder:
    """The results of one sweep: the baseline, then each point's accuracy
    (under its name + `suffix`: the detection strips' '_mAP'), its delta
    (rounded to 4 places, as JAX's) and its wall seconds."""

    def __init__(self, results: dict, suffix: str = ''):
        self.results = results
        self.results.setdefault('_seconds', {})
        self.suffix = suffix
        self.start = time.perf_counter()

    def baseline(self, acc):
        self.results['full-prec' + self.suffix] = float(acc)
        self._timed('full-prec')
        if self.suffix:
            print(json.dumps({'full-prec' + self.suffix: round(float(acc), 4)}), flush=True)

    def record(self, key, acc):
        acc = float(acc)
        self.results[key + self.suffix] = acc
        self.results[key + '_delta'] = round(self.results['full-prec' + self.suffix] - acc, 4)
        self._timed(key)
        print(json.dumps({key + self.suffix: round(acc, 4),
                          'delta': self.results[key + '_delta']}), flush=True)

    def _timed(self, key):
        now = time.perf_counter()
        self.results['_seconds'][key] = round(now - self.start, 1)
        self.start = now


def _train_eval(create, helper_cls, name: str, eval_builder: str, device):
    """Train learner `name` and evaluate its state with its `eval_builder`;
    returns the eval metrics."""
    learner = create(None, helper_cls(), learner_name=name, device=device)
    state = learner.train()
    return learner.run_eval_loop(state, getattr(learner, eval_builder)())


# ---------------------------------------------------------------------------
# the sweeps
# ---------------------------------------------------------------------------

def run_sweep(workdir=None, quick=False, device='cuda', overrides=None, points=None):
    """Every learner on ResNet-20 over the hard task (14 points; 9 with
    `quick`), or the baseline and the `points` named (keys of
    LOCKED_MAX_DELTA).  Returns the results dict."""
    workdir = workdir or tempfile.mkdtemp(prefix='pf_parity_')
    results = {'_quick': bool(quick)}
    flags = Flagged(overrides)
    flags.start(resnet20_flags(workdir, 0.1 if quick else 0.2))

    from pocketflow_tpu_torch import learners
    from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper

    def point(name, eval_builder):
        return _train_eval(learners.create_learner, ModelHelper, name, eval_builder, device)

    def wanted(key):
        return points is None or key in points

    # 1. full-precision baseline (its checkpoint feeds every compression learner)
    rec = Recorder(results)
    rec.baseline(point('full-prec', 'build_eval_step')['accuracy'])

    # 2. weight sparsification at the reference's sparsity ladder
    ws_points = [0.75] if quick else [0.5, 0.75, 0.9, 0.95]
    for pr in (p for p in ws_points if wanted('weight-sparse@%d%%' % int(p * 100))):
        with flags.scope(ws_prune_ratio=pr, ws_prune_ratio_prtl='uniform',
                         ws_mask_update_step=20,
                         ws_save_path=os.path.join(workdir, 'ws%d/model.ckpt' % int(pr * 100))):
            metrics = point('weight-sparse', 'build_sparse_eval_step')
            rec.record('weight-sparse@%d%%' % int(pr * 100), metrics['accuracy'])
            results['weight-sparse@%d%%_pr' % int(pr * 100)] = float(metrics['pr_msk'])

    # 3. uniform quantization at 4 and 8 bits, channel buckets
    uq_points = [4] if quick else [4, 8]
    for bits in (b for b in uq_points if wanted('uniform@%dbit' % b)):
        with flags.scope(uql_weight_bits=bits, uql_use_buckets=True,
                         uql_bucket_type='channel', uql_quant_epochs=30,
                         uql_quantize_all_layers=False,
                         uql_save_quant_model_path=os.path.join(workdir,
                                                                'uql%d/model.ckpt' % bits)):
            rec.record('uniform@%dbit' % bits,
                       point('uniform', 'build_quant_eval_step')['accuracy'])

    # 4. deployment QAT 8/8 (uniform-tf)
    if wanted('uniform-tf@8/8'):
        with flags.scope(uql_quant_epochs=30, uqtf_quant_delay=0, uqtf_freeze_bn_delay=None,
                         uqtf_save_path=os.path.join(workdir, 'uqtf/model.ckpt')):
            rec.record('uniform-tf@8/8', point('uniform-tf', 'build_qat_eval_step')['accuracy'])

    # 5. non-uniform quantization at 4 and 8 bits, codebooks
    for bits in (b for b in uq_points if wanted('non-uniform@%dbit' % b)):
        with flags.scope(nuql_weight_bits=bits, nuql_quant_epochs=30,
                         nuql_opt_mode='both', nuql_quantize_all_layers=False,
                         nuql_save_quant_model_path=os.path.join(workdir,
                                                                 'nuql%d/model.ckpt' % bits)):
            rec.record('non-uniform@%dbit' % bits,
                       point('non-uniform', 'build_quant_eval_step')['accuracy'])

    # 6. channel pruning (PGD) at 50%
    if wanted('chn-pruned-gpu@50%'):
        with flags.scope(cpg_prune_ratio=0.5, cpg_skip_ht_layers=True,
                         cpg_nb_iters_layer=24 if quick else 60,
                         cpg_save_path=os.path.join(workdir, 'cpg/model.ckpt')):
            rec.record('chn-pruned-gpu@50%',
                       point('chn-pruned-gpu', 'build_pruned_eval_step')['accuracy'])

    # 7. LASSO channel pruning (He-2017) at ~50% FLOPs (preserve 0.5):
    # ft_ratio 1.0 x the sweep's nb_epochs_rat 0.2 equals the reference's
    # default finetune fraction
    if wanted('channel@50%'):
        with flags.scope(cp_prune_option='uniform', cp_uniform_preserve_ratio=0.5,
                         cp_nb_batches=6, cp_nb_points_per_layer=8,
                         cp_nb_iters_ft_ratio=1.0,
                         cp_channel_pruned_path=os.path.join(workdir, 'cp/model.ckpt')):
            rec.record('channel@50%', point('channel', 'build_eval_step')['accuracy'])

    # 7b. the same with the schedule finetune (--cp_finetune_schedule)
    if wanted('channel@50%+sched'):
        with flags.scope(cp_prune_option='uniform', cp_uniform_preserve_ratio=0.5,
                         cp_nb_batches=6, cp_nb_points_per_layer=8,
                         cp_nb_iters_ft_ratio=1.0, cp_finetune_schedule=True,
                         cp_channel_pruned_path=os.path.join(workdir, 'cps/model.ckpt')):
            rec.record('channel@50%+sched', point('channel', 'build_eval_step')['accuracy'])

    # 8. remastered channel pruning at 50%
    if wanted('chn-pruned-rmt@50%'):
        with flags.scope(cpr_prune_ratio=0.5, cpr_skip_frst_layer=True,
                         cpr_nb_smpls=512, cpr_nb_crops_per_smpl=6,
                         cpr_ista_nb_iters=60, cpr_lstsq_nb_iters=60,
                         cp_nb_batches=6,
                         cpr_save_path=os.path.join(workdir, 'cpr/model.ckpt')):
            rec.record('chn-pruned-rmt@50%', point('chn-pruned-rmt', 'build_eval_step')['accuracy'])

    # 9. discrimination-aware channel pruning at 50%
    if wanted('dis-chn-pruned@50%'):
        with flags.scope(dcp_prune_ratio=0.5, dcp_nb_stages=2,
                         dcp_nb_iters_block=20 if quick else 40,
                         dcp_nb_iters_layer=1 if quick else 2,
                         dcp_save_path=os.path.join(workdir, 'dcp/model.ckpt')):
            rec.record('dis-chn-pruned@50%', point('dis-chn-pruned', 'build_eval_step')['accuracy'])

    return results


def run_sweep_mobilenet(workdir=None, quick=False, device='cuda', overrides=None, points=None):
    """The MobileNet-v1 strip at the reference's headline operating points
    (6 points; 2 with `quick`) on the 96x96 hard task, or the baseline and
    the `points` named (keys of LOCKED_MAX_DELTA_MOBILENET).  Returns the
    results dict."""
    workdir = workdir or tempfile.mkdtemp(prefix='pf_parity_mb_')
    results = {'_quick': bool(quick), '_family': 'mobilenet_v1'}
    flags = Flagged(overrides)
    flags.start(mobilenet_flags(workdir, 0.05 if quick else 0.2))

    from pocketflow_tpu_torch import learners
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper

    def point(name, eval_builder):
        return _train_eval(learners.create_learner, ModelHelper, name, eval_builder, device)

    def wanted(key):
        return points is None or key in points

    rec = Recorder(results)
    rec.baseline(point('full-prec', 'build_eval_step')['accuracy'])

    ws_points = [0.5] if quick else [0.5, 0.9]
    for pr in (p for p in ws_points if wanted('weight-sparse@%d%%' % int(p * 100))):
        with flags.scope(ws_prune_ratio=pr, ws_prune_ratio_prtl='uniform',
                         ws_mask_update_step=20,
                         ws_save_path=os.path.join(workdir, 'ws%d/model.ckpt' % int(pr * 100))):
            rec.record('weight-sparse@%d%%' % int(pr * 100),
                       point('weight-sparse', 'build_sparse_eval_step')['accuracy'])

    if wanted('uniform-tf@8/8'):
        with flags.scope(uql_quant_epochs=30, uqtf_quant_delay=0, uqtf_freeze_bn_delay=None,
                         uqtf_save_path=os.path.join(workdir, 'uqtf/model.ckpt')):
            rec.record('uniform-tf@8/8', point('uniform-tf', 'build_qat_eval_step')['accuracy'])

    if not quick and wanted('chn-pruned-gpu@50%'):
        with flags.scope(cpg_prune_ratio=0.5, cpg_skip_ht_layers=True, cpg_nb_iters_layer=60,
                         cpg_save_path=os.path.join(workdir, 'cpg/model.ckpt')):
            rec.record('chn-pruned-gpu@50%',
                       point('chn-pruned-gpu', 'build_pruned_eval_step')['accuracy'])

    # the He-2017 LASSO recipe behind the reference's CP MobileNet table
    if not quick and wanted('channel@50%'):
        with flags.scope(cp_prune_option='uniform', cp_uniform_preserve_ratio=0.5,
                         cp_nb_batches=6, cp_nb_points_per_layer=8,
                         cp_nb_iters_ft_ratio=1.0,
                         cp_channel_pruned_path=os.path.join(workdir, 'cp/model.ckpt')):
            rec.record('channel@50%', point('channel', 'build_eval_step')['accuracy'])

    # the schedule-finetune variant (see run_sweep 7b)
    if not quick and wanted('channel@50%+sched'):
        with flags.scope(cp_prune_option='uniform', cp_uniform_preserve_ratio=0.5,
                         cp_nb_batches=6, cp_nb_points_per_layer=8,
                         cp_nb_iters_ft_ratio=1.0, cp_finetune_schedule=True,
                         cp_channel_pruned_path=os.path.join(workdir, 'cps/model.ckpt')):
            rec.record('channel@50%+sched', point('channel', 'build_eval_step')['accuracy'])

    return results


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

def commit() -> Optional[str]:
    """The commit the code runs from: $PF_COMMIT, else ``git rev-parse
    HEAD`` in the repo, else None (a copy without .git)."""
    if os.environ.get('PF_COMMIT'):
        return os.environ['PF_COMMIT']
    try:
        out = subprocess.run(['git', 'rev-parse', 'HEAD'], capture_output=True, text=True,
                             cwd=os.path.dirname(os.path.abspath(__file__)), timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return (out.stdout.strip() or None) if out.returncode == 0 else None


def result_path(tag: str, publish: bool) -> str:
    """Where `tag`.json goes: under RESULTS_DIR when `publish`, else under
    $PF_PARITY_OUT (default: pf_parity_results in the temporary directory)."""
    out_dir = RESULTS_DIR if publish else os.environ.get(
        'PF_PARITY_OUT', os.path.join(tempfile.gettempdir(), 'pf_parity_results'))
    return os.path.join(out_dir, tag + '.json')


def finish(results: dict, tag: str, publish: bool, card: Optional[str]) -> str:
    """Round the accuracies to 4 places (as JAX's), add the card and the
    commit, and write `tag`.json (`result_path`).  Returns the path."""
    for key, value in list(results.items()):
        if isinstance(value, float):
            results[key] = round(value, 4)
    results['_card'] = card
    results['_commit'] = commit()
    path = result_path(tag, publish)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as fout:
        json.dump(results, fout, indent=2)
    print('results written to %s%s' % (path, '' if publish else
                                       ' (use --publish to update the committed evidence)'),
          flush=True)
    return path


def report(violations: List[str], header: str, healthy: str) -> int:
    """Print the violations under `header`, or `healthy`; 1 if any, else 0."""
    if violations:
        print(header)
        for v in violations:
            print('  ' + v)
        return 1
    print(healthy)
    return 0


def parse_seeds(text: str) -> List[int]:
    """'0-7' or '0,4,5' as a list of seeds."""
    if '-' in text:
        first, last = text.split('-')
        return list(range(int(first), int(last) + 1))
    return [int(k) for k in text.split(',')]


def baseline_seeds(family: str, seeds: List[int], publish: bool, card: Optional[str],
                   device='cuda', overrides=None) -> dict:
    """The strip's full-precision baseline alone at each seed of `seeds`
    (--rand_seed: the initial weights and the augmentation; the task stays
    the same), its accuracy and whether it lands in the baseline band;
    written as `<strip>_seeds.json` (`finish`).  Returns the results."""
    band = _bands_for(family)[0]
    run = run_sweep_mobilenet if family == 'mobilenet_v1' else run_sweep
    results = {'_family': family, '_band': list(band), '_seconds': {}, 'seeds': {}}
    for seed in seeds:
        start = time.perf_counter()
        out = run(device=device, overrides={**(overrides or {}), 'rand_seed': seed}, points=())
        acc = out['full-prec']
        results['seeds'][str(seed)] = round(acc, 4)
        results['_seconds'][str(seed)] = round(time.perf_counter() - start, 1)
        print(json.dumps({'rand_seed': seed, 'full-prec': round(acc, 4),
                          'in_band': band[0] <= acc <= band[1]}), flush=True)
    results['in_band'] = sum(band[0] <= a <= band[1] for a in results['seeds'].values())
    results['of'] = len(seeds)
    print(json.dumps({'in_band': results['in_band'], 'of': results['of']}), flush=True)
    tag = 'parity_hard_mobilenet_seeds' if family == 'mobilenet_v1' else 'parity_hard_seeds'
    finish(results, tag, publish, card)
    return results


def _healthy(family: str) -> str:
    return 'parity bands: all %d points within locked bands' % len(_bands_for(family)[1])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--family', default='resnet20', choices=('resnet20', 'mobilenet_v1'))
    parser.add_argument('--quick', action='store_true', help='the reduced points')
    parser.add_argument('--check', action='store_true', help='exit 1 on a band violation')
    parser.add_argument('--check-file', help='only check the results in this JSON file')
    parser.add_argument('--publish', action='store_true',
                        help='write a full sweep to %s' % RESULTS_DIR)
    parser.add_argument('--baseline-seeds', metavar='A-B',
                        help='only the baseline, once at each --rand_seed in A..B (or A,B,...): '
                        'how often it lands in its band')
    args = parser.parse_args(argv)
    if args.check_file:
        with open(args.check_file) as fin:
            data = json.load(fin)
        family = data.get('_family', args.family)
        code = report(check_results(data, family), 'PARITY BAND VIOLATIONS:',
                      _healthy(family))
        if code:
            sys.exit(code)
        return data
    require_cuda('synthetic_parity')
    import torch
    from pocketflow_tpu_torch.core.cuda_timing import card_line
    card = card_line()
    print('card: %s | %s' % (card, torch.cuda.get_device_name(0)), flush=True)
    if args.baseline_seeds:
        return baseline_seeds(args.family, parse_seeds(args.baseline_seeds), args.publish, card)
    if args.family == 'mobilenet_v1':
        out = run_sweep_mobilenet(quick=args.quick)
        tag = 'parity_hard_mobilenet'
    else:
        out = run_sweep(quick=args.quick)
        tag = 'parity_hard'
    finish(out, tag, args.publish and not args.quick, card)
    print(json.dumps(out, indent=2), flush=True)
    if args.check:
        code = report(check_results(out, args.family), 'PARITY BAND VIOLATIONS:',
                      _healthy(args.family))
        if code:
            sys.exit(code)
    return out


if __name__ == '__main__':
    main()
