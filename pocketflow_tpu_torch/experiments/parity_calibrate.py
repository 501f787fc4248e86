"""Calibrate the hard parity task on one GPU (counterpart of
experiments/parity_calibrate.py): the full-precision baseline's held-out
accuracy against the task's snr, for ResNet-20 (32x32) and the MobileNet-v1
strip (depth 0.5 at 96x96), at synthetic_parity.py's flags.  The harness's
snr values (0.18 and 0.15) put the baseline mid-band, where a compression
fault shows.

    python -m pocketflow_tpu_torch.experiments.parity_calibrate [--snr 0.15,0.18,0.20]
    python -m pocketflow_tpu_torch.experiments.parity_calibrate --family mobilenet_v1 --snr 0.10,0.15
"""

from __future__ import annotations

import argparse
import json
import tempfile

from pocketflow_tpu_torch.experiments import require_cuda
from pocketflow_tpu_torch.experiments import synthetic_parity as sp


def run_one(snr: float, seed: int = 0, epochs_rat: float = 0.2, family: str = 'resnet20',
            device='cuda', overrides=None) -> float:
    """The full-prec baseline's eval accuracy at `snr` and `seed`."""
    workdir = tempfile.mkdtemp(prefix='pf_cal_')
    flags = sp.Flagged(overrides)
    if family == 'mobilenet_v1':
        from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper
        base = dict(sp.mobilenet_flags(workdir, epochs_rat), summ_step=200)
    else:
        from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper
        base = dict(sp.resnet20_flags(workdir, epochs_rat), summ_step=200)
    flags.start(dict(base, synthetic_snr=snr, rand_seed=seed))
    from pocketflow_tpu_torch.learners import create_learner
    learner = create_learner(None, ModelHelper(), learner_name='full-prec', device=device)
    state = learner.train()
    return float(learner.run_eval_loop(state, learner.build_eval_step())['accuracy'])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--snr', default='0.06,0.08,0.10',
                        help='comma-separated snr values')
    parser.add_argument('--family', default='resnet20', choices=('resnet20', 'mobilenet_v1'))
    parser.add_argument('--epochs_rat', type=float, default=None,
                        help='nb_epochs_rat (default 0.15 for mobilenet_v1, else 0.2)')
    args = parser.parse_args(argv)
    require_cuda('parity_calibrate')
    from pocketflow_tpu_torch.core.cuda_timing import card_line
    print('card: %s' % card_line(), flush=True)
    epochs_rat = args.epochs_rat
    if epochs_rat is None:
        epochs_rat = 0.15 if args.family == 'mobilenet_v1' else 0.2
    results = {}
    for snr in (float(v) for v in args.snr.split(',')):
        acc = run_one(snr, family=args.family, epochs_rat=epochs_rat)
        results['snr=%.3f' % snr] = round(acc, 4)
        print(json.dumps(results), flush=True)
    return results


if __name__ == '__main__':
    main()
