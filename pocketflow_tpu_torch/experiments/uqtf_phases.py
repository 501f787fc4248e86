"""The uniform-tf learner's step time in each phase of its recipe, on one GPU
(counterpart of experiments/uqtf_phases.py): QAT ResNet-50 at 224x224, bf16,
batch $BENCH_BATCH_SIZE (256), the space-to-depth stem, synthetic ILSVRC-12,
``--uqtf_quant_delay=1000``.  One learner, one batch, three phases, each
timed over 10 steps after 4 and ended by a synchronize:

1. warm-up: before the quant delay, quantization off, exact BN;
2. QAT with the EMA activation ranges and exact BN (the step set past the
   delay);
3. QAT with BN frozen (the recipe's steady state, its longest phase).

In the QAT phases the weights go through one grouped K2' launch a forward
(``fake_quant_bucket_group``, channel buckets, no select) and the
activations through the plain ``fake_quant_with_range``; the warm-up
launches no kernel.  Each phase prints its ms a step, images/s and the
kernel launches counted over its steps.

    python -m pocketflow_tpu_torch.experiments.uqtf_phases

It runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from pocketflow_tpu_torch.experiments import require_cuda
from pocketflow_tpu_torch.experiments import synthetic_parity as sp

BATCH = int(os.environ.get('BENCH_BATCH_SIZE', '256'))
WARM_REPS, TIMED_REPS = 4, 10
PAST_DELAY = 2000  # the step count set for the QAT phases (the JAX script's)
PHASES = ('warmup (quant off, exact BN)', 'QAT (EMA ranges, exact BN)',
          'QAT + frozen BN (steady state)')


def phase_flags(batch: int) -> dict:
    """The JAX script's flags."""
    return dict(synthetic_data=True, compute_dtype='bfloat16',
                summ_step=10 ** 9, save_step=10 ** 9,
                resnet_stem_s2d=True, batch_size=batch,
                batch_size_eval=batch, nb_smpls_train=4096,
                nb_smpls_eval=512, nb_epochs_rat=1.0,
                uqtf_quant_delay=1000)


def _sync(device: torch.device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run(batch: int = BATCH, warm: int = WARM_REPS, reps: int = TIMED_REPS, device='cuda',
        overrides=None, make_helper=None) -> dict:
    """The three phases of one learner on one batch; returns {'batch',
    'phases': {name: {'ms', 'img_s', 'steps', 'launches'}}}, `launches` the
    fake-quant kernels' counters over the phase's warm and timed steps.
    `make_helper` builds the model helper (default: ResNet-50 at ILSVRC-12)."""
    from pocketflow_tpu_torch.learners.uniform_quantization_tf.learner import \
        UniformQuantTFLearner
    from pocketflow_tpu_torch.ops import fake_quant as fq
    if make_helper is None:
        from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper

        def make_helper():
            return ModelHelper(resnet_size=50)
    flags = sp.Flagged(overrides)
    with flags.scope(**phase_flags(batch)):
        learner = UniformQuantTFLearner(None, make_helper(), device=device)
        state, tx, _ = learner.init_state_quant()
        step_bn = learner.build_qat_train_step(tx, freeze_bn=False)
        step_frozen = learner.build_qat_train_step(tx, freeze_bn=True)
        data = learner.put_batch(next(learner.dataset_train.build()))
        dev = learner.device

        def timed(step, state):
            fq.reset_counters()
            for i in range(warm):
                state, _ = step(state, data, learner.generator(100 + i))
            _sync(dev)
            start = time.perf_counter()
            for i in range(reps):
                state, metrics = step(state, data, learner.generator(i))
            _sync(dev)
            ms = (time.perf_counter() - start) / reps * 1e3
            if not torch.isfinite(metrics['loss']):
                raise RuntimeError('non-finite loss %s' % float(metrics['loss']))
            return {'ms': ms, 'img_s': batch / ms * 1e3, 'steps': warm + reps,
                    'launches': {k: v for k, v in fq.counters().items() if v}}, state

        phases = {}
        phases[PHASES[0]], state = timed(step_bn, state)
        state.step = PAST_DELAY
        phases[PHASES[1]], state = timed(step_bn, state)
        phases[PHASES[2]], state = timed(step_frozen, state)
    for name, ph in phases.items():
        print('%-34s %7.2f ms/step  (%4.0f img/s)  launches over %d steps: %s'
              % (name, ph['ms'], ph['img_s'], ph['steps'], ph['launches']), flush=True)
    return {'batch': batch, 'phases': phases}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.parse_args(argv)
    require_cuda('uqtf_phases')
    from pocketflow_tpu_torch.core.cuda_timing import card_line
    card = card_line()
    out = dict(run(), card=card)
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
