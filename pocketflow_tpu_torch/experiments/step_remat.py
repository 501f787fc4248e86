"""Does block rematerialization pay on the QAT ResNet-50 step, on one GPU?
(counterpart of experiments/step_remat.py)

    python -m pocketflow_tpu_torch.experiments.step_remat [--batch 256] [--out FILE]

Runs the QAT ResNet-50 train step of UniformQuantLearner at bench.py's
settings (224x224, bf16, exact BN, space-to-depth stem, synthetic ILSVRC-12,
4-bit weights) under each --remat_blocks mode.  One learner draws one
seeded initial state; each mode's model is built by the model helper under
that mode's flag and loaded with it, with its own SGD state.  For each
mode: the peak memory of its first step (torch.cuda.reset_peak_memory_stats
before it, max_memory_allocated after it; and the peak above the memory
allocated before it, which holds the parameters, momentum and gradients of
the modes measured before it and the batch), then the
modes in turns over 4 windows of 10 steps each, as the JAX script's, timed
on the host clock and ended by torch.cuda.synchronize(), then 3 steps of
each under torch.profiler: the device's busy time a step, its idle share
and its events (tools/profile_step.py).  The JAX script timed the modes
alone; the peak memory and the device profile are new.  Results go to
--out (default: step_remat.json in a directory under the system's
temporary directory).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from typing import Dict, Sequence

import torch

from pocketflow_tpu_torch.core.cuda_timing import card_line
from pocketflow_tpu_torch.experiments import require_cuda

MODES = ('none', 'save_convs', 'full')
NB_WINDOWS, NB_STEPS, PROFILE_STEPS = 4, 10, 3


def settings(batch: int) -> dict:
    """The flags of the main path's step at `batch`."""
    return dict(synthetic_data=True, compute_dtype='bfloat16', summ_step=10 ** 9,
                save_step=10 ** 9, resnet_stem_s2d=True, batch_size=batch, batch_size_eval=batch,
                nb_smpls_train=max(4096, batch), nb_smpls_eval=512, nb_epochs_rat=1.0,
                bn_stats_subsample=1, uql_weight_bits=4, rand_seed=0)


def build_learner():
    """The QAT ResNet-50 learner on the card, its train step and one batch
    on the card, under the flags in force."""
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper
    learner = UniformQuantLearner(None, ModelHelper(resnet_size=50), device='cuda')
    base, tx, _ = learner.init_state_quant()
    batch = learner.put_batch(next(learner.dataset_train.build()))
    return learner, base, tx, learner.build_quant_train_step(tx), batch


def state_under(learner, base, tx, mode: str, extra=None):
    """A TrainState at `base`'s parameters and BN statistics with fresh SGD
    momentum and `extra` (default: base's), its model built by the learner's
    model helper under --remat_blocks=`mode`."""
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.learners.abstract_learner import TrainState
    with FLAGS.scope(remat_blocks=mode):
        model = learner.model_helper.create_model()
    model.load_state_dict(base.model.state_dict())
    model = model.to(learner.device)
    return TrainState(step=base.step, model=model, optimizer=tx.init(model),
                      extra=base.extra if extra is None else extra)


def snapshot(state) -> Dict[str, torch.Tensor]:
    """Parameters, BN statistics and SGD momentum after a step, cloned."""
    out = {'model/' + k: v.detach().clone() for k, v in state.model.state_dict().items()}
    for i, group in enumerate(state.optimizer.state.values()):
        out.update({'opt/%d/%s' % (i, k): v.clone() for k, v in group.items()
                    if torch.is_tensor(v)})
    return out


def peak_step(learner, state, step, batch, seed: int = 0):
    """One step of `state`: (the state, its peak memory in bytes, the memory
    allocated before it)."""
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, batch, learner.generator(seed))
    torch.cuda.synchronize()
    return state, torch.cuda.max_memory_allocated(), start


def time_in_turns(learner, states: Dict[str, object], step, batch, nb_windows: int,
                  nb_steps: int) -> Dict[str, list]:
    """{mode: [ms a step of each window]}: the modes in turns, each window
    `nb_steps` steps on the host clock, ended by a synchronize."""
    times = {mode: [] for mode in states}
    for window in range(nb_windows):
        for mode, state in states.items():
            torch.cuda.synchronize()
            start = time.perf_counter()
            for i in range(nb_steps):
                state, _ = step(state, batch, learner.generator(1000 * window + i))
            torch.cuda.synchronize()
            times[mode].append(1e3 * (time.perf_counter() - start) / nb_steps)
            states[mode] = state
    return times


def device_profile(learner, state, step, batch, nb_steps: int) -> dict:
    """The device's share of `nb_steps` steps under torch.profiler (device
    activity only): busy ms a step (the union of kernels, copies and
    memsets), the idle share of the window, device events a step."""
    from pocketflow_tpu_torch.tools.profile_step import _profile, summarize
    held = [state]

    def one(i):
        held[0], _ = step(held[0], batch, learner.generator(10 ** 6 + i))

    summary = summarize(_profile(one, nb_steps)[0], nb_steps)
    return {key: summary[key] for key in ('busy_ms_per_step', 'window_ms_per_step',
                                          'idle_share', 'device_events_per_step')}


def run(modes: Sequence[str], nb_windows: int, nb_steps: int, built=None,
        profile_steps: int = 0) -> dict:
    """The measurement under the flags in force (see the module's doc), on
    `built` (build_learner()'s result) or a learner built here; with
    `profile_steps`, each mode's device_profile over that many steps after
    the timed windows."""
    learner, base, tx, step, batch = built or build_learner()
    states, out = {}, {}
    for mode in modes:
        state, peak, start = peak_step(learner, state_under(learner, base, tx, mode), step,
                                       batch)
        states[mode] = state
        out[mode] = {'peak_gib': peak / 2 ** 30, 'allocated_before_gib': start / 2 ** 30,
                     'step_gib': (peak - start) / 2 ** 30}
    times = time_in_turns(learner, states, step, batch, nb_windows, nb_steps)
    size = int(batch['image'].shape[0])
    for mode in modes:
        med = statistics.median(times[mode])
        out[mode].update(ms=times[mode], median_ms=med, img_s=size / med * 1e3)
        if profile_steps:
            out[mode]['device'] = device_profile(learner, states[mode], step, batch,
                                                 profile_steps)
    return out


def default_out() -> str:
    return os.path.join(tempfile.gettempdir(), 'pocketflow_tpu_torch', 'step_remat.json')


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--batch', type=int, default=256)
    parser.add_argument('--out', default=default_out())
    args = parser.parse_args(argv)
    require_cuda('step_remat')
    from pocketflow_tpu_torch.config import FLAGS
    # the flags of the settings
    import pocketflow_tpu_torch.learners.uniform_quantization.learner  # noqa: F401
    import pocketflow_tpu_torch.nets.resnet_at_ilsvrc12  # noqa: F401
    card = card_line()
    print('card: %s' % card, flush=True)
    with FLAGS.scope(**settings(args.batch)):
        results = run(MODES, NB_WINDOWS, NB_STEPS, profile_steps=PROFILE_STEPS)
    for mode, row in results.items():
        print('%-11s: %8.2f ms/step (%.0f img/s), peak %.2f GiB (%.2f GiB above the %.2f GiB '
              'allocated before the step), windows %s' % (
                  mode, row['median_ms'], row['img_s'], row['peak_gib'], row['step_gib'],
                  row['allocated_before_gib'], ['%.1f' % t for t in row['ms']]), flush=True)
        if 'device' in row:
            print('%-11s  device busy %.2f ms a step, idle %.1f%%, %d events a step' % (
                mode, row['device']['busy_ms_per_step'], 100 * row['device']['idle_share'],
                row['device']['device_events_per_step']), flush=True)
    results = {'card': card, 'batch': args.batch, 'modes': results}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as fout:
        json.dump(results, fout, indent=1)
    print(json.dumps(results), flush=True)
    return results


if __name__ == '__main__':
    main()
