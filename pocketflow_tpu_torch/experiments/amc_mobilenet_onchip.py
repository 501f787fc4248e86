"""The AMC search drill on one GPU (counterpart of
experiments/amc_mobilenet_onchip.py): MobileNet-v1 at 224x224, batch 32, 16
classes of synthetic data, warm-trained for ``--warm_steps`` steps, then a
DDPG channel-ratio search of ``--rlouts`` roll-outs under a 0.5
preserved-FLOPs budget (2 batches and 4 points a layer).

It drives the search's machinery end to end: the agent's updates, the LASSO
selection and reconstruction of every layer in each roll-out, rewards from
the train set's held-out part, the FLOPs budget and the search checkpoint
written each roll-out.  It is not evidence of the search's quality: a
drill's warm-up leaves the baseline far from trained, so the rewards barely
vary (amc_vs_uniform.py measures the quality).  It checks that the search's
checkpoint was written and that the preserved FLOPs are within the budget,
and writes the reward trace and the best ratios as amc_mobilenet_r3.json.

    python -m pocketflow_tpu_torch.experiments.amc_mobilenet_onchip [--publish]
    python -m pocketflow_tpu_torch.experiments.amc_mobilenet_onchip --rlouts 4 --warm_steps 20

It runs on the card; the result goes where synthetic_parity.py's go
(``--publish``: pocketflow_tpu_torch/experiments/results/).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from pocketflow_tpu_torch.experiments import require_cuda
from pocketflow_tpu_torch.experiments import synthetic_parity as sp
from pocketflow_tpu_torch.experiments.amc_vs_uniform import preserved_flops_frac

TAG = 'amc_mobilenet_r3'
NB_EVAL_BATCHES = 4  # the baseline's accuracy: 4 train batches, as the JAX drill's


def drill_flags(workdir: str, rlouts: int) -> dict:
    """The JAX drill's flags."""
    return dict(batch_size=32, batch_size_eval=32, nb_classes=16,
                nb_smpls_train=2048, nb_smpls_val=256, nb_smpls_eval=256,
                nb_epochs_rat=0.15, lrn_rate_init=0.05, mobilenet_version=1,
                cp_prune_option='auto', cp_preserve_ratio=0.5,
                cp_nb_rlouts=rlouts, cp_nb_rlouts_min=max(2, rlouts // 4),
                cp_nb_batches=2, cp_nb_points_per_layer=4,
                cp_best_path=os.path.join(workdir, 'best_model.ckpt'))


def run(rlouts: int = 12, warm_steps: int = 600, device='cuda', overrides=None,
        workdir=None) -> dict:
    """Warm-train, search, check; returns the drill's result."""
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.learners.channel_pruning.learner import ChannelPrunedLearner
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper
    workdir = workdir or tempfile.mkdtemp(prefix='pf_amc_r3_')
    flags = sp.Flagged(overrides)
    flags.start({})  # the overrides alone: the drill's flags are a scope
    with flags.scope(**drill_flags(workdir, rlouts)):
        learner = ChannelPrunedLearner(None, ModelHelper(), device=device)
        state, tx, _ = learner.init_state()

        # warm-train so that pruning damage shows in the reward
        step = learner.build_train_step(tx)
        train_it = learner.dataset_train.build()
        start = time.perf_counter()
        for i in range(warm_steps):
            state, _ = step(state, learner.put_batch(next(train_it)), learner.generator(i))
        eval_step = learner.build_eval_step()
        base_acc = float(np.mean([float(eval_step(state, learner.put_batch(next(train_it)))[
            'accuracy']) for _ in range(NB_EVAL_BATCHES)]))
        print('warm-trained baseline accuracy (train batches): %.3f' % base_acc, flush=True)
        warm_s = time.perf_counter() - start

        learner._setup_pruner(state)
        start = time.perf_counter()
        ratios = learner.search_ratios_rl(state)
        wall = time.perf_counter() - start

        preserved = preserved_flops_frac(learner.specs, ratios)
        if preserved > FLAGS.cp_preserve_ratio + 1e-6:
            raise RuntimeError('the search kept %.4f of the FLOPs, over its budget %.2f'
                               % (preserved, FLAGS.cp_preserve_ratio))
        if not os.path.exists(os.path.join(workdir, 'ddpg_search.npz')):
            raise RuntimeError('the search checkpoint ddpg_search.npz is missing')
        rewards = [float(r) for r, _ in learner.search_trace]
        dev = torch.device(device)
        return {
            'date': time.strftime('%Y-%m-%d'),
            'device': torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu',
            'model': 'mobilenet_v1', 'image_size': learner.dataset_train.spec.image_shape[0],
            'nb_rlouts': rlouts, 'nb_prunable_convs': len(learner.specs),
            'warm_steps': warm_steps,
            'baseline_accuracy': round(base_acc, 4),
            'wall_s': round(wall, 1),
            'preserved_flops_frac': round(preserved, 4),
            'reward_trace': [round(r, 4) for r in rewards],
            'best_reward': round(max(rewards), 4) if rewards else None,
            'best_ratios': [round(float(r), 3) for r in ratios],
            '_seconds': {'warm': round(warm_s, 1), 'search': round(wall, 1)},
        }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--rlouts', type=int, default=12)
    parser.add_argument('--warm_steps', type=int, default=600)
    parser.add_argument('--publish', action='store_true',
                        help='write the result to %s' % sp.RESULTS_DIR)
    args = parser.parse_args(argv)
    require_cuda(TAG)
    from pocketflow_tpu_torch.core.cuda_timing import card_line
    card = card_line()
    print('card: %s' % card, flush=True)
    result = run(args.rlouts, args.warm_steps)
    sp.finish(result, TAG, args.publish, card)
    print(json.dumps(result), flush=True)
    return result


if __name__ == '__main__':
    main()
