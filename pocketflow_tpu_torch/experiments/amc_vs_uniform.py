"""AMC against uniform channel pruning at equal preserved FLOPs on one GPU
(counterpart of experiments/amc_vs_uniform.py), on the MobileNet-v1 strip of
the hard synthetic task (synthetic_parity.mobilenet_flags: 96x96, depth
multiplier 0.5, snr 0.15, bf16, batch 128):

1. train the full-prec baseline;
2. a DDPG search (``--rlouts`` roll-outs, ``--rlouts_min`` before the agent
   exploits) with the LASSO channel pruner in auto mode, under a 0.5
   preserved-FLOPs budget, 6 batches and 8 points a layer;
3. fully finetune the ``--topk`` best distinct candidates by fast reward
   and keep the one with the best accuracy over at most 12 batches of the
   train set's held-out part: the test set is read once, for the winner;
4. prune uniformly at the winner's preserved-FLOPs fraction from the same
   baseline checkpoint and finetune it the same way;
5. hold RL >= uniform - NOISE, at preserved FLOPs in [0.3, 0.55].

The result also records whether the baseline lands in the strip's band
(``baseline_in_band``): at some seeds the strip's baseline memorizes its
train set, and a comparison finetuned from such a net says little.  That
is a recorded field, not a check.

    python -m pocketflow_tpu_torch.experiments.amc_vs_uniform [--rand_seed K] [--publish]
    python -m pocketflow_tpu_torch.experiments.amc_vs_uniform --rlouts 4 --quick
    python -m pocketflow_tpu_torch.experiments.amc_vs_uniform --check-file FILE

It runs on the card; results go where synthetic_parity.py's go, and a full
``--publish`` run writes pocketflow_tpu_torch/experiments/results/
amc_vs_uniform.json (``amc_vs_uniform_seed<K>.json`` at ``--rand_seed K``
other than 0).  The process exits 1 when a full run leaves the band.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Sequence

import numpy as np
import torch

from pocketflow_tpu_torch.experiments import require_cuda
from pocketflow_tpu_torch.experiments import synthetic_parity as sp

NOISE = 0.02  # the JAX script's run-to-run eval noise at 2048 eval samples
TAG = 'amc_vs_uniform'
HEADER = 'AMC-vs-uniform BAND VIOLATIONS:'
HEALTHY = 'amc-vs-uniform band: RL beats uniform at equal FLOPs'


def check_results(results):
    """The locked claim: RL >= uniform - noise at equal preserved FLOPs."""
    violations = []
    for key in ('rl_accuracy', 'uniform_accuracy', 'preserved_flops_frac'):
        if key not in results:
            violations.append('%s missing from results' % key)
    if violations:
        return violations
    if results['rl_accuracy'] < results['uniform_accuracy'] - NOISE:
        violations.append(
            'RL-searched ratios (%.4f) lost to uniform (%.4f) by more than '
            'the noise band %.2f' % (results['rl_accuracy'],
                                     results['uniform_accuracy'], NOISE))
    if not 0.3 <= results['preserved_flops_frac'] <= 0.55:
        violations.append('preserved FLOPs %.3f is not a ~50%% operating '
                          'point' % results['preserved_flops_frac'])
    return violations


def search_flags(workdir: str, rlouts: int, rlouts_min: int) -> dict:
    """The RL arm's flags (the JAX script's)."""
    return dict(cp_prune_option='auto', cp_preserve_ratio=0.5,
                cp_nb_rlouts=rlouts, cp_nb_rlouts_min=rlouts_min,
                cp_nb_batches=6, cp_nb_points_per_layer=8, cp_nb_iters_ft_ratio=1.0,
                cp_best_path=os.path.join(workdir, 'rl/best_model.ckpt'),
                cp_channel_pruned_path=os.path.join(workdir, 'rl/model.ckpt'))


def uniform_flags(workdir: str, preserved: float) -> dict:
    """The uniform arm's flags (the JAX script's)."""
    return dict(cp_prune_option='uniform', cp_uniform_preserve_ratio=preserved,
                cp_nb_batches=6, cp_nb_points_per_layer=8, cp_nb_iters_ft_ratio=1.0,
                cp_channel_pruned_path=os.path.join(workdir, 'uni/model.ckpt'))


def preserved_flops_frac(specs: Sequence[dict], ratios: Sequence[float]) -> float:
    """The FLOPs of the prunable convs kept at `ratios`, over their total."""
    flops = np.array([s['flops'] for s in specs], np.float64)
    return float(np.sum(flops * np.asarray(ratios, np.float64)) / flops.sum())


def result_tag(rand_seed: int) -> str:
    return TAG if rand_seed == 0 else '%s_seed%d' % (TAG, rand_seed)


def run(workdir=None, quick=False, rlouts=60, rlouts_min=15, topk=3, rand_seed=0,
        device='cuda', overrides=None) -> dict:
    """The five steps above; returns the results dict."""
    workdir = workdir or tempfile.mkdtemp(prefix='pf_amc_vs_uniform_')
    results = {'_quick': bool(quick), 'rand_seed': rand_seed, '_seconds': {}}
    flags = sp.Flagged(overrides)
    flags.start(dict(sp.mobilenet_flags(workdir, 0.05 if quick else 0.2), rand_seed=rand_seed))

    from pocketflow_tpu_torch.learners import create_learner
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper
    start = time.perf_counter()

    def lap(key):
        nonlocal start
        now = time.perf_counter()
        results['_seconds'][key] = round(now - start, 1)
        start = now

    # 1. baseline
    learner = create_learner(None, ModelHelper(), learner_name='full-prec', device=device)
    state = learner.train()
    baseline = float(learner.run_eval_loop(state, learner.build_eval_step())['accuracy'])
    band = sp.BASELINE_BAND_MOBILENET
    results['baseline_accuracy'] = round(baseline, 4)
    results['baseline_in_band'] = bool(band[0] <= baseline <= band[1])
    del learner, state
    lap('baseline')
    print(json.dumps({'baseline_accuracy': results['baseline_accuracy'],
                      'baseline_in_band': results['baseline_in_band']}), flush=True)

    # 2. the RL search, then the top-k candidates finetuned and chosen on
    # the held-out part of the train set (ChannelPrunedLearner.train's
    # search_ratios_rl + prune_and_finetune, taken apart)
    with flags.scope(**search_flags(workdir, rlouts, rlouts_min)):
        rl_learner = create_learner(None, ModelHelper(), learner_name='channel', device=device)
        rl_learner.require_dp_only('the LASSO prune/search phase')
        state0, _, _ = rl_learner.init_state()
        state0, _ = rl_learner.restore_baseline(state0)
        rl_learner._setup_pruner(state0)
        best_ratios = rl_learner.search_ratios_rl(state0)
        candidates = rl_learner.search_topk[:max(1, topk)] or [(float('nan'), best_ratios)]
        del state0
        lap('search')

        eval_step = rl_learner.build_eval_step()
        _, val_iter = rl_learner.dataset_train.build(enbl_trn_val_split=True)
        nb_val = max(1, min(12, rl_learner.dataset_train.spec.nb_smpls_val
                            // rl_learner.dataset_train.batch_size))
        cand_rows, best_val, rl_state, ratios = [], -np.inf, None, None
        for ci, (reward, cand) in enumerate(candidates):
            with flags.scope(cp_channel_pruned_path=os.path.join(
                    workdir, 'rl/cand%d/model.ckpt' % ci)):
                st, _, _ = rl_learner.init_state()
                st, _ = rl_learner.restore_baseline(st)
                st = rl_learner.prune_and_finetune(st, cand)
            val_acc = float(np.mean([float(eval_step(st, rl_learner.put_batch(
                next(val_iter)))['accuracy']) for _ in range(nb_val)]))
            cand_rows.append({'reward': round(float(reward), 4),
                              'val_accuracy': round(val_acc, 4),
                              'ratios': [round(float(r), 3) for r in cand]})
            print(json.dumps({'candidate': ci, **cand_rows[-1]}), flush=True)
            if val_acc > best_val:
                best_val, rl_state, ratios = val_acc, st, list(cand)
        # the test set is read once, for the winner
        rl_acc = float(rl_learner.run_eval_loop(rl_state, eval_step)['accuracy'])
        preserved = preserved_flops_frac(rl_learner.specs, ratios)
        trace = [round(float(r), 4) for r, _ in rl_learner.search_trace]
        del rl_state, rl_learner
    lap('candidates')
    results.update({
        'rl_accuracy': round(rl_acc, 4),
        'rl_ratios': [round(float(r), 3) for r in ratios],
        'preserved_flops_frac': round(preserved, 4),
        'nb_rlouts': rlouts, 'nb_rlouts_min': rlouts_min,
        'topk': len(candidates),
        'rl_selection': 'full-finetune top-k, winner by val accuracy',
        'candidates': cand_rows,
        'reward_trace': trace,
        'search_wall_s': results['_seconds']['search'],
    })
    print(json.dumps({'rl_accuracy': results['rl_accuracy'],
                      'preserved_flops_frac': preserved}), flush=True)

    # 3. uniform at the same preserved-FLOPs fraction, from the same
    # baseline checkpoint, with the same finetune
    with flags.scope(**uniform_flags(workdir, preserved)):
        uni_learner = create_learner(None, ModelHelper(), learner_name='channel', device=device)
        uni_state = uni_learner.train()
        uni_acc = float(uni_learner.run_eval_loop(
            uni_state, uni_learner.build_eval_step())['accuracy'])
    lap('uniform')
    results['uniform_accuracy'] = round(uni_acc, 4)
    print(json.dumps({'uniform_accuracy': results['uniform_accuracy']}), flush=True)
    results['device'] = (torch.cuda.get_device_name(torch.device(device))
                         if torch.device(device).type == 'cuda' else 'cpu')
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--rlouts', type=int, default=60)
    parser.add_argument('--rlouts_min', type=int, default=15)
    parser.add_argument('--topk', type=int, default=3,
                        help='fully finetune the K best distinct candidates and select by VAL '
                        'accuracy (1 = trust the reward argmax)')
    parser.add_argument('--rand_seed', type=int, default=0,
                        help='the strip\'s --rand_seed (initial weights and augmentation)')
    parser.add_argument('--quick', action='store_true')
    parser.add_argument('--publish', action='store_true',
                        help='write a full run to %s' % sp.RESULTS_DIR)
    parser.add_argument('--check-file', dest='check_file', default=None)
    args = parser.parse_args(argv)
    if args.check_file:
        with open(args.check_file) as fin:
            data = json.load(fin)
        if sp.report(check_results(data), HEADER, HEALTHY):
            sys.exit(1)
        return data
    require_cuda(TAG)
    from pocketflow_tpu_torch.core.cuda_timing import card_line
    card = card_line()
    print('card: %s | %s' % (card, torch.cuda.get_device_name(0)), flush=True)
    out = run(quick=args.quick, rlouts=args.rlouts, rlouts_min=args.rlouts_min,
              topk=args.topk, rand_seed=args.rand_seed)
    sp.finish(out, result_tag(args.rand_seed), args.publish and not args.quick, card)
    print(json.dumps(out, indent=2), flush=True)
    if not args.quick and sp.report(check_results(out), HEADER, HEALTHY):
        sys.exit(1)
    return out


if __name__ == '__main__':
    main()
