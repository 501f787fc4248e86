"""Readings for a cell's correctness limits: the program's numbers over
many seeds (the lower readings), the control's and the planted faults'
(the upper readings), and a second witness.

    python3 -m pfbench.control --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--witness-seeds 1,2] [--out FILE]

Training cells: for each seed, the program's checked steps (the step a run
builds and times, fed as a run feeds it) against the reference, every
number of ``compare.train_numbers``; for each control seed, the reference
computed in float8 (the control, ``reference/ops.py``) and the reference with
half of each batch left out, the mean taken over the rest (a planted
fault), each against the reference; for each witness seed, the program at
``compute_dtype=float32`` against the reference.  Serving cells: for each
seed, the program's logits of ``sampled_requests`` requests and the int8
sites' outputs of the first against the reference; for each control seed,
the reference at int4 against the reference at int8.  Each seed's
readings print as a JSON line.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import torch

from pfbench import compare, harness
from pfbench import weights as made
from pfbench.reference import serve as ref_serve
from pfbench.reference import train as ref_train


def train_program(loaded: Dict, seed: int, device: torch.device, overrides=None) -> Dict:
    """The program's readings of the checked steps at `seed`."""
    from pfbench.drivers import train
    cfg, traffic = loaded['cfg'], loaded['traffic']
    batch = int(traffic['batch'])
    checked = int(traffic['checked_steps'])
    modules = ['pocketflow_tpu_torch.nets.' + cfg['helper']] + traffic['flag_modules']
    flags = {'batch_size': batch, 'rand_seed': seed % (2 ** 31), **(overrides or {})}
    with harness.program_flags(modules, cfg['flags'], traffic['flags'], flags):
        learner, state, step, _ = train.build(cfg, traffic, seed, device)
        batches = made.train_batches(cfg, batch, checked, seed, device)

        def one(i):
            return step(state, batches[i], learner.generator(made.flip_seed(seed, i)))

        state, _, program = train.warm_up(state, one, {**traffic, 'warmup_steps': checked})
        del state, step, learner
    harness.free(device)
    return program


def train_readings(loaded: Dict, seeds: List[int], control_seeds: List[int],
                   witness_seeds: List[int], device: torch.device, with_program: bool = True):
    cfg, traffic = loaded['cfg'], loaded['traffic']
    batch = int(traffic['batch'])
    checked = int(traffic['checked_steps'])
    for seed in seeds:
        weights = {k: v.cpu() for k, v in made.make_weights(cfg, seed, device).items()}
        batches = made.train_batches(cfg, batch, checked, seed, device)
        flips = [made.flip_seed(seed, i) for i in range(checked)]
        reference = ref_train.run_steps(cfg, traffic, weights, batches, flips)
        out = {'seed': seed, 'reference_losses': reference['losses'], 'readings': {}}

        def read(label, program):
            out['readings'][label] = compare.train_numbers(program, reference,
                                                           compare.last_kernel(cfg))

        if with_program:
            read('program', train_program(loaded, seed, device))
        if seed in control_seeds:
            read('control_fp8', ref_train.run_steps(cfg, traffic, weights, batches, flips,
                                                    precision='fp8'))
            read('fault_half_batch', ref_train.run_steps(cfg, traffic, weights, batches, flips,
                                                         rows=batch // 2))
        if seed in witness_seeds:
            read('witness_fp32_program',
                 train_program(loaded, seed, device, {'compute_dtype': 'float32'}))
        del batches
        harness.free(device)
        yield out


def serve_readings(loaded: Dict, seeds: List[int], control_seeds: List[int], device):
    from pfbench.drivers import serve
    cfg, traffic = loaded['cfg'], loaded['traffic']
    batch = int(traffic['batch'])
    sampled = int(traffic['sampled_requests'])
    levels = int(traffic['levels'])
    modules = ['pocketflow_tpu_torch.nets.' + cfg['helper']] + traffic['flag_modules']
    for seed in seeds:
        with harness.program_flags(modules, cfg['flags'], traffic['flags'],
                                   {'batch_size': batch, 'batch_size_eval': batch}):
            forward, weights, sites = serve.build(cfg, traffic, seed, device)
            requests = made.normal_images(cfg, batch, sampled, seed, made.REQUESTS, device,
                                          torch.bfloat16)
            served = [forward(x).float() for x in requests[1:]]
            first, outputs = serve.site_outputs(forward, sites, requests[0])
            served.insert(0, first.float())
            del forward, sites, first
        harness.free(device)
        calib = made.normal_images(cfg, batch, int(traffic['calibration_batches']), seed,
                                   made.CALIBRATION, device)
        scales = ref_serve.calibrate(cfg, weights, calib, levels)
        want, gaps, local = serve.reference_gaps(cfg, weights, scales, levels, requests[0],
                                                 outputs)
        want = [want] + [ref_serve.forward(cfg, weights, scales, x, levels)
                         for x in requests[1:]]
        out = {'seed': seed, 'readings': {'program': {
            'logit_gap': (max(compare.row_gap(y, w) for y, w in zip(served, want)), ''),
            'site_gap': serve.site_gap(gaps), 'site_gap.local': serve.site_gap(local)}}}
        if seed in control_seeds:
            scales4 = ref_serve.calibrate(cfg, weights, calib, 7)
            kept = {}
            got = [ref_serve.forward(cfg, weights, scales4, requests[0], 7,
                                     on_site=lambda path, x, y: kept.__setitem__(path, (x, y)))]
            got += [ref_serve.forward(cfg, weights, scales4, x, 7) for x in requests[1:]]
            _, gaps4, local4 = serve.reference_gaps(cfg, weights, scales, levels, requests[0],
                                                    kept)
            out['readings']['control_int4'] = {
                'logit_gap': (max(compare.row_gap(y, w) for y, w in zip(got, want)), ''),
                'site_gap': serve.site_gap(gaps4), 'site_gap.local': serve.site_gap(local4)}
            del got, kept
        del served, want, requests, calib
        harness.free(device)
        yield out


def main(argv=None, root: str = '.', device: str = 'cuda', sizes=None) -> List[Dict]:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--control-seeds', default='')
    parser.add_argument('--witness-seeds', default='')
    parser.add_argument('--no-program', action='store_true',
                        help='read the control and the faults only')
    parser.add_argument('--out', default='')
    args = parser.parse_args(argv)
    ints = lambda text: [int(x) for x in text.split(',') if x]  # noqa: E731
    loaded = harness.load_cell(root, args.workload, sizes)
    dev = torch.device(device)
    if loaded['traffic']['driver'] == 'serve':
        rows = serve_readings(loaded, ints(args.seeds), ints(args.control_seeds), dev)
    else:
        rows = train_readings(loaded, ints(args.seeds), ints(args.control_seeds),
                              ints(args.witness_seeds), dev, not args.no_program)
    out = []
    for row in rows:
        out.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, 'w') as fout:
                json.dump(out, fout, indent=1)
    return out


if __name__ == '__main__':
    main(sys.argv[1:])
