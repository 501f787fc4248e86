"""The composed pipeline weight-sparsify -> QAT on one GPU (counterpart of
experiments/composed_ws_qat.py), on the ResNet-20 strip of the hard
synthetic task (synthetic_parity.py):

1. train the full-prec baseline;
2. weight-sparse at 50% (uniform protocol, Zhu & Gupta's schedule);
3. QAT-finetune the sparse checkpoint at 8/8 bits with the element masks
   held (masked gradients and a re-zero after each update), through the
   same checkpoint transport as composed_cp_qat.py;
4. hold the stacked delta and the mask-survival invariant to the JAX
   script's bands: the maskable-weight zero fraction must be the same
   before and after the QAT finetune.

    python -m pocketflow_tpu_torch.experiments.composed_ws_qat [--publish]
    python -m pocketflow_tpu_torch.experiments.composed_ws_qat --quick
    python -m pocketflow_tpu_torch.experiments.composed_ws_qat --check-file FILE

It runs on the card; a full ``--publish`` run writes
pocketflow_tpu_torch/experiments/results/composed_ws_qat.json.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Tuple

import torch

from pocketflow_tpu_torch.experiments import composed_cp_qat as cp
from pocketflow_tpu_torch.experiments import synthetic_parity as sp

# the JAX script's locked bands: stacked delta +0.0073 measured, the band is
# the WS@50% band, two-sided like every other strip
LOCKED_MAX_STACKED_DELTA = 0.05
LOCKED_MIN_STACKED_DELTA = -0.09
# the uniform 50% magnitude pruning must actually have pruned: zero fraction
# over maskable kernels (the WS learner lands exactly at ws_prune_ratio)
MIN_SPARSITY_FRAC = 0.45


def check_results(results):
    violations = []
    base = results.get('full-prec')
    if base is None:
        return ['full-prec baseline missing from results']
    quick = bool(results.get('_quick'))
    band = (0.0, 1.0) if quick else sp.BASELINE_BAND
    if not band[0] <= base <= band[1]:
        violations.append('full-prec accuracy %.4f outside band [%.2f, %.2f]'
                          % (base, *band))
    delta = results.get('ws+qat@8bit_delta')
    if delta is None:
        violations.append('ws+qat@8bit stacked point missing from results')
    elif not quick:
        if delta > LOCKED_MAX_STACKED_DELTA:
            violations.append(
                'stacked delta %.4f exceeds locked band %.2f'
                % (delta, LOCKED_MAX_STACKED_DELTA))
        if delta < LOCKED_MIN_STACKED_DELTA:
            violations.append(
                'stacked delta %.4f "improves" past the two-sided floor %.2f '
                '— suspect a baseline/train-pipeline regression'
                % (delta, LOCKED_MIN_STACKED_DELTA))
    frac = results.get('sparsity_frac')
    if frac is None:
        violations.append('sparsity_frac missing from results')
    elif not quick and frac < MIN_SPARSITY_FRAC:
        violations.append('maskable zero fraction %.3f below %.2f — the '
                          'composed point did not actually sparsify'
                          % (frac, MIN_SPARSITY_FRAC))
    # composition contract: the element masks must survive the QAT finetune
    frac_after = results.get('sparsity_frac_after_qat')
    if frac_after is None:
        violations.append('sparsity_frac_after_qat missing from results')
    elif frac is not None and abs(frac_after - frac) > 1e-4:
        violations.append(
            'maskable zero fraction changed across the QAT finetune '
            '(%.4f -> %.4f) — masks did not survive; the composed point is '
            'not measuring the stacked pipeline' % (frac, frac_after))
    return violations


def derive_sparse_masks(model: torch.nn.Module) -> Tuple[Dict[str, torch.Tensor], float]:
    """Element masks from the exactly-zero maskable weights (the WS learner
    keeps pruned weights at literal 0), keyed by parameter name as
    ``masking.build_mask_state``'s: fp32 (w != 0) on the maskable kernels, a
    0-d one elsewhere.  Returns (masks, the zero fraction of the maskable
    weights)."""
    from pocketflow_tpu_torch.learners.weight_sparsification import masking
    zeroed = total = 0
    masks = {}
    for name, p in model.named_parameters():
        if masking.is_maskable_path(name):
            alive = p.detach() != 0
            zeroed += int((~alive).sum())
            total += alive.numel()
            masks[name] = alive.to(torch.float32)
        else:
            masks[name] = torch.ones((), device=p.device)
    return masks, zeroed / max(total, 1)


def run(workdir=None, quick=False, device='cuda', overrides=None):
    workdir = workdir or tempfile.mkdtemp(prefix='pf_composed_ws_')
    results = {'_quick': bool(quick)}
    flags = sp.Flagged(overrides)
    flags.start(sp.resnet20_flags(workdir, 0.02 if quick else 0.2,
                                  512 if quick else 4096))

    from pocketflow_tpu_torch.learners import create_learner
    from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper

    # 1. full-prec baseline
    rec = sp.Recorder(results)
    learner = create_learner(None, ModelHelper(), learner_name='full-prec', device=device)
    state = learner.train()
    rec.baseline(learner.run_eval_loop(state, learner.build_eval_step())['accuracy'])
    del learner, state

    # 2. weight-sparse at 50%, uniform protocol, Zhu & Gupta's schedule
    ws_path = os.path.join(workdir, 'ws/model.ckpt')
    with flags.scope(ws_prune_ratio=0.5, ws_prune_ratio_prtl='uniform',
                     ws_mask_update_step=20, ws_save_path=ws_path):
        wsl = create_learner(None, ModelHelper(), learner_name='weight-sparse', device=device)
        ws_state = wsl.train()
        rec.record('weight-sparse@50%',
                   wsl.run_eval_loop(ws_state, wsl.build_sparse_eval_step())['accuracy'])
        del wsl, ws_state

    # 3. QAT 8/8 from the sparse checkpoint, element masks held
    acc, frac, frac_after, _ = cp.masked_qat(ModelHelper(), ws_path, workdir, 'ws_uql',
                                             derive_sparse_masks, device)
    results['sparsity_frac'] = round(frac, 4)
    results['sparsity_frac_after_qat'] = round(frac_after, 4)
    rec.record('ws+qat@8bit', acc)
    return results


def main(argv=None) -> dict:
    return cp.main(argv, 'composed_ws_qat', run, check_results,
                   'composed ws+qat bands: evidence healthy')


if __name__ == '__main__':
    main()
