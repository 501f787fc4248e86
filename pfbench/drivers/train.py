"""A training cell: the learner's train step from its configuration and
traffic mix, driven as the program's train loop drives it.

Set-up builds the learner and its state (``init_state_quant``), loads the
weights made from the seed, builds the step the traffic names, stages the
distinct batches on the card and runs the warm-up steps through the very
step and feed the window uses.  The first ``checked_steps`` of them are what
the reference follows: each step's loss, each leaf's first gradient (the
SGD momentum after one step) and each leaf's change over them.  Then the
window: steps back to back for ``seconds``, each from a staged batch and a
fresh augmentation generator, ended by a synchronize.  With ``trace``, a
traced segment of ``traced_steps`` more steps follows the window.
"""

from __future__ import annotations

import importlib
import math
import time
from typing import Dict

import torch

from pfbench import compare, flops, harness, tracing
from pfbench import weights as made
from pfbench.reference import train as reference


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def build(cfg: Dict, traffic: Dict, seed: int, device: torch.device):
    """(learner, state, step, weights on the host) of the cell, the
    program's flags in force."""
    from pocketflow_tpu_torch.learners.learner_utils import create_learner
    helper = importlib.import_module('pocketflow_tpu_torch.nets.' + cfg['helper'])
    learner = create_learner(None, helper.ModelHelper(**cfg['helper_args']), traffic['learner'],
                             device=device)
    state, tx, _ = learner.init_state_quant()
    weights = made.make_weights(cfg, seed, device)
    state.model.load_state_dict(weights, strict=True)
    host = {k: v.cpu() for k, v in weights.items()}
    spec = traffic['step']
    step = getattr(learner, spec['method'])(tx, **spec.get('kwargs', {}))
    return learner, state, step, host


def warm_up(state, one, traffic: Dict):
    """Run the warm-up steps (``one(i)`` is step i of the feed) and read the
    checked ones: (state, the last step's metrics, {'losses', 'grad1',
    'change'})."""
    checked, warmup = int(traffic['checked_steps']), int(traffic['warmup_steps'])
    params = dict(state.model.named_parameters())
    first = {k: p.detach().clone() for k, p in params.items()}
    extra = {k: state.extra[k].detach().clone() for k in traffic['extra_leaves']}
    program = {'losses': []}
    for i in range(warmup):
        state, metrics = one(i)
        if i < checked:
            program['losses'].append(metrics['loss'])
        if i == 0:
            momenta = {k: state.optimizer.state.get(p, {}).get('momentum_buffer')
                       for k, p in params.items()}
            program['grad1_t'] = {k: torch.zeros_like(p, device='cpu') if m is None
                                  else m.detach().to('cpu', copy=True) for (k, m), p
                                  in zip(momenta.items(), params.values())}
        if i == checked - 1:
            change = {k: p.detach() - first[k] for k, p in params.items()}
            change.update({k: state.extra[k] - v for k, v in extra.items()})
            program['change_t'] = {k: v.to('cpu', copy=True) for k, v in change.items()}
            del first, extra, change
    program['losses'] = [float(x) for x in program['losses']]
    program['grad1'] = _norms(program['grad1_t'])
    program['change'] = _norms(program['change_t'])
    return state, metrics, program


def run(loaded: Dict, seed: int, seconds: float, trace: bool, device: str, start: float) -> Dict:
    cfg, traffic = loaded['cfg'], loaded['traffic']
    dev = torch.device(device)
    batch = int(traffic['batch'])
    checked, warmup = int(traffic['checked_steps']), int(traffic['warmup_steps'])
    t_build = time.perf_counter()
    flags = {'batch_size': batch, 'rand_seed': seed % (2 ** 31)}
    modules = ['pocketflow_tpu_torch.nets.' + cfg['helper']] + traffic['flag_modules']
    with harness.program_flags(modules, cfg['flags'], traffic['flags'], flags):
        learner, state, step, host_weights = build(cfg, traffic, seed, dev)
        batches = made.train_batches(cfg, batch, int(traffic['distinct_batches']), seed, dev)
        nb = len(batches)

        def one(i):
            with tracing.span('stage'):
                feed = batches[i % nb], learner.generator(made.flip_seed(seed, i))
            return step(state, *feed)

        t_warm = time.perf_counter()
        state, metrics, program = warm_up(state, one, traffic)
        harness.sync(dev)
        harness.note('set-up: %.2f s to the build, %.2f s to build, %.2f s to warm up'
                     % (t_build - start, t_warm - t_build, time.perf_counter() - t_warm))

        # the window
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        t_start = time.perf_counter()
        done, dispatch = 0, []
        while True:
            t_call = time.perf_counter()
            if t_call - t_start >= seconds:
                break
            with tracing.span('step'):
                state, metrics = one(warmup + done)
            dispatch.append(1e3 * (time.perf_counter() - t_call))
            done += 1
        with tracing.span('sync'):
            harness.sync(dev)
        t_end = time.perf_counter()
        last_loss = float(metrics['loss'])
        window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
        img_s = done * batch / (t_end - t_start)
        values = {'train_img_s': img_s, 'train_peak_gib': window_peak / 2 ** 30,
                  'setup_s': t_start - start}
        harness.note('%d steps in %.3f s: %.2f img/s, peak %.3f GiB, set-up %.2f s'
                     % (done, t_end - t_start, img_s, window_peak / 2 ** 30, t_start - start))

        traced_run = None
        if trace:
            units = int(traffic['traced_steps'])

            def unit(j):
                with tracing.span('step'):
                    one(warmup + done + j)
                if (j + 1) % (units + harness.TRACE_WARM) == 0:
                    with tracing.span('sync'):
                        harness.sync(dev)

            traced_run = harness.traced(loaded, unit, units, {
                'kind': 'train', 'batch': batch, 'img_s': img_s, 'dispatch_ms': dispatch,
                'train_flops': flops.train_flops(cfg)})
        device_info = harness.device_info(dev, int(loaded['cell']['chips']))
        del state, step, learner, metrics
    kept = batches[:checked]
    del batches
    harness.free(dev)

    # the reference follows the checked steps
    ref = reference.run_steps(cfg, traffic, host_weights, kept,
                              [made.flip_seed(seed, i) for i in range(checked)])
    numbers = compare.train_numbers(program, ref, compare.last_kernel(cfg))
    harness.note('losses %s, reference %s' % (program['losses'], ref['losses']))
    correct, checks = compare.judge(numbers, loaded['limits'])
    if not math.isfinite(last_loss):
        harness.note('the window\'s last loss is %r' % last_loss)
    return harness.result(loaded, values, traced_run, device_info,
                          correct and math.isfinite(last_loss), done,
                          0 if math.isfinite(last_loss) else done, numbers, checks)
