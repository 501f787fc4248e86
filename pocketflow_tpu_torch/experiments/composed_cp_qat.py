"""The composed pipeline channel-prune -> QAT -> export on one GPU
(counterpart of experiments/composed_cp_qat.py), on the ResNet-20 strip of
the hard synthetic task (synthetic_parity.py):

1. train the full-prec baseline;
2. LASSO channel-prune at 50% preserve with the schedule finetune (the
   strip's channel@50%+sched point);
3. QAT-finetune the pruned checkpoint at 8/8 bits with the channel masks
   held (masked gradients and a re-zero after each update, the composed
   step of ``learners/weight_sparsification/pruned_qat.py``); the
   parameters and BN statistics move between the learners through the
   checkpoint (``AbstractLearner.restore_baseline``), the masks are read
   back from the pruned channels, which are exactly 0;
4. export: the residual-aware channel shrink of the final parameters
   (``tools/shrink_graph.py``), recording the packed parameter fraction;
5. hold the stacked delta, the pruned-channel fraction before and after
   QAT, and the packed fraction to the JAX script's locked bands.

    python -m pocketflow_tpu_torch.experiments.composed_cp_qat [--publish]
    python -m pocketflow_tpu_torch.experiments.composed_cp_qat --quick
    python -m pocketflow_tpu_torch.experiments.composed_cp_qat --check-file FILE

It runs on the card; results go where synthetic_parity.py's go, and a full
``--publish`` run writes pocketflow_tpu_torch/experiments/results/
composed_cp_qat.json.  The process exits 1 when a full run leaves a band.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.experiments import require_cuda
from pocketflow_tpu_torch.experiments import synthetic_parity as sp

# the JAX script's locked bands: the single-learner points measured
# channel@50%+sched at -0.0278 and uniform@8bit at +0.0015; the stacked
# budget allows the CP band plus quantization noise, two-sided
LOCKED_MAX_STACKED_DELTA = 0.12
LOCKED_MIN_STACKED_DELTA = -0.09
# uniform 50%-preserve pruning must actually have pruned: the zeroed
# input-channel fraction over CP-targeted kernels
MIN_PRUNED_CHANNEL_FRAC = 0.30
# the residual-aware shrink must physically remove parameters
MAX_PACKED_PARAM_FRAC = 0.80
HEADER = 'COMPOSED PIPELINE BAND VIOLATIONS:'


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
    delta = results.get('cp+qat@8bit_delta')
    if delta is None:
        violations.append('cp+qat@8bit stacked point missing from results')
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
    frac = results.get('pruned_channel_frac')
    if frac is None:
        violations.append('pruned_channel_frac missing from results')
    elif not quick and frac < MIN_PRUNED_CHANNEL_FRAC:
        violations.append('pruned channel fraction %.3f below %.2f — the '
                          'composed point did not actually prune'
                          % (frac, MIN_PRUNED_CHANNEL_FRAC))
    packed = results.get('packed_param_frac')
    if packed is not None and not quick and packed > MAX_PACKED_PARAM_FRAC:
        violations.append('packed param fraction %.3f above %.2f — the '
                          'shrink export removed too few parameters'
                          % (packed, MAX_PACKED_PARAM_FRAC))
    # the composition contract: the channel masks must survive the QAT
    # finetune untouched (masked grads + post-update re-zero)
    frac_after = results.get('pruned_channel_frac_after_qat')
    if frac_after is None:
        violations.append('pruned_channel_frac_after_qat missing from results')
    elif frac is not None and abs(frac_after - frac) > 1e-4:
        violations.append(
            'pruned channel fraction changed across the QAT finetune '
            '(%.4f -> %.4f) — masks did not survive; the composed point is '
            'not measuring the stacked pipeline' % (frac, frac_after))
    return violations


def derive_channel_masks(model: torch.nn.Module) -> Tuple[Dict[str, torch.Tensor], float]:
    """Input-channel masks from the exactly-zero input channels of the
    pruned model's HWIO kernels (the CP finetune keeps pruned channels at
    literal 0), keyed by parameter name: [1, 1, c, 1] where a 4-D kernel
    with more than one input channel has a zero channel, a 0-d one
    elsewhere.  Returns (masks, the zeroed fraction of those kernels' input
    channels)."""
    zeroed = total = 0
    masks = {}
    for name, p in model.named_parameters():
        masks[name] = torch.ones((), device=p.device)
        if p.dim() == 4 and p.shape[2] > 1:
            alive = p.detach().to(torch.float32).abs().sum(dim=(0, 1, 3)) > 0
            total += alive.numel()
            if not bool(alive.all()):
                zeroed += int((~alive).sum())
                masks[name] = alive.to(torch.float32).reshape(1, 1, -1, 1)
    return masks, zeroed / max(total, 1)


def masked_qat(model_helper, src_path: str, workdir: str, tag: str,
               derive: Callable, device) -> Tuple[float, float, float, object]:
    """QAT 8/8 from the newest checkpoint under `src_path`, with the masks
    `derive(model)` gives held through the finetune (``pruned_qat``'s
    composed step).  Returns (accuracy, the masks' fraction before, after,
    the final state)."""
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.learners.weight_sparsification import pruned_qat
    with FLAGS.scope(uql_weight_bits=8, uql_activation_bits=8, uql_quant_epochs=30,
                     uql_save_quant_model_path=os.path.join(workdir, tag, 'model.ckpt')):
        uq = UniformQuantLearner(None, model_helper, device=device)
        state, tx, _ = uq.init_state_quant()
        state, restored = uq.restore_baseline(state, src_path)
        if not restored:
            raise FileNotFoundError('no checkpoint under ' + src_path)
        masks, frac = derive(state.model)
        state, train_step = pruned_qat.build_pruned_qat_step(uq, tx, state, masks)
        eval_step = uq.build_quant_eval_step()
        state = uq.run_train_loop(state, train_step, nb_iters=uq.finetune_steps,
                                  save_path=FLAGS.uql_save_quant_model_path,
                                  eval_fn=lambda s: uq.run_eval_loop(s, eval_step))
        acc = float(uq.run_eval_loop(state, eval_step)['accuracy'])
        _, frac_after = derive(state.model)
    return acc, frac, frac_after, state


def packed_param_frac(model: torch.nn.Module, image_shape) -> float:
    """The residual-aware shrink's packed size over the dense size
    (parameters and BN statistics)."""
    from pocketflow_tpu_torch.core.bridge import to_jax_numpy
    from pocketflow_tpu_torch.tools import shrink_graph as sg
    params, batch_stats = to_jax_numpy(model)
    graph = sg.capture_conv_graph(model, (1,) + tuple(image_shape))
    packed, _ = sg.shrink_residual_aware(params, batch_stats, graph)
    dense = sum(int(np.asarray(v).size) for _, v in sg.tree_leaves(params)
                + sg.tree_leaves(batch_stats))
    small = sum(int(np.asarray(v).size) for v in packed.values())
    return small / max(dense, 1)


def run(workdir=None, quick=False, device='cuda', overrides=None):
    workdir = workdir or tempfile.mkdtemp(prefix='pf_composed_')
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
    image_shape = learner.dataset_train.spec.image_shape
    del learner, state

    # 2. channel prune at 50% preserve, schedule finetune
    cp_path = os.path.join(workdir, 'cp/model.ckpt')
    with flags.scope(cp_prune_option='uniform', cp_uniform_preserve_ratio=0.5,
                     cp_nb_batches=6, cp_nb_points_per_layer=8,
                     cp_nb_iters_ft_ratio=1.0, cp_finetune_schedule=True,
                     cp_channel_pruned_path=cp_path):
        cpl = create_learner(None, ModelHelper(), learner_name='channel', device=device)
        cp_state = cpl.train()
        rec.record('channel@50%+sched',
                   cpl.run_eval_loop(cp_state, cpl.build_eval_step())['accuracy'])
        del cpl, cp_state

    # 3. QAT 8/8 from the pruned checkpoint, channel masks held
    acc, frac, frac_after, state_q = masked_qat(ModelHelper(), cp_path, workdir, 'cp_uql',
                                                derive_channel_masks, device)
    results['pruned_channel_frac'] = round(frac, 4)
    results['pruned_channel_frac_after_qat'] = round(frac_after, 4)
    rec.record('cp+qat@8bit', acc)

    # 4. export: residual-aware physical shrink of the composed params
    results['packed_param_frac'] = round(packed_param_frac(state_q.model, image_shape), 4)
    print(json.dumps({'packed_param_frac': results['packed_param_frac']}), flush=True)
    return results


def main(argv=None, tag='composed_cp_qat', run_fn=None, check_fn=None,
         healthy='composed cp+qat bands: evidence healthy') -> dict:
    """The CLI (composed_ws_qat.py's too, through `tag`, `run_fn` and
    `check_fn`)."""
    run_fn, check_fn = run_fn or run, check_fn or check_results
    parser = argparse.ArgumentParser(description=(sys.modules[run_fn.__module__].__doc__
                                                  or '').split('\n\n')[0])
    parser.add_argument('--quick', action='store_true', help='a short smoke run')
    parser.add_argument('--check-file', help='only check the results in this JSON file')
    parser.add_argument('--publish', action='store_true',
                        help='write a full run to %s' % sp.RESULTS_DIR)
    args = parser.parse_args(argv)
    if args.check_file:
        with open(args.check_file) as fin:
            data = json.load(fin)
        if sp.report(check_fn(data), HEADER, healthy):
            sys.exit(1)
        return data
    require_cuda(tag)
    from pocketflow_tpu_torch.core.cuda_timing import card_line
    card = card_line()
    print('card: %s | %s' % (card, torch.cuda.get_device_name(0)), flush=True)
    out = run_fn(quick=args.quick)
    sp.finish(out, tag, args.publish and not args.quick, card)
    print(json.dumps(out, indent=2), flush=True)
    if not args.quick and sp.report(check_fn(out), HEADER, healthy):
        sys.exit(1)
    return out


if __name__ == '__main__':
    main()
