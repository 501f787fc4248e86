"""Interleaved cuBLAS-vs-kernel matmul sweep over ResNet-50's 1x1-conv shapes
(counterpart of experiments/mm_shape_sweep.py), on one GPU.

    python -m pocketflow_tpu_torch.experiments.mm_shape_sweep [--rounds 5] [--reps 8]
        [--out FILE]

Shapes: the bottleneck 1x1 convs of ResNet-50 at 224, batch 256 (rows =
N*H*W at that stage), x ~ N(0, 1) and w ~ 0.05 N(0, 1) in bf16.  For each
shape the two arms, torch.matmul (cuBLAS) and matmul_bf16 (csrc/matmul.cu),
are timed in turn for `--rounds` rounds of `--reps` calls each (CUDA events
around each round), and the medians are reported with the rate against the
bytes of x, w and y, and beside the shape's bound (the larger of those bytes
over the H100's memory rate and 2MKN over its bf16 tensor-core rate).  The
last line is the results as JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys

import torch

from pocketflow_tpu_torch.core.cuda_timing import card_line, matmul_bound_ms, time_ms
from pocketflow_tpu_torch.experiments import require_cuda
from pocketflow_tpu_torch.ops.matmul import matmul_bf16

# (M, K, N): rows, in-channels, out-channels of ResNet-50 batch-256 1x1 convs
SHAPES = [
    (256 * 56 * 56, 64, 256),     # stage1 expand
    (256 * 56 * 56, 256, 64),     # stage1 reduce
    (256 * 28 * 28, 128, 512),    # stage2 expand
    (256 * 28 * 28, 512, 128),    # stage2 reduce
    (256 * 14 * 14, 256, 1024),   # stage3 expand
    (256 * 14 * 14, 1024, 256),   # stage3 reduce
    (256 * 7 * 7, 512, 2048),     # stage4 expand
    (256 * 7 * 7, 2048, 512),     # stage4 reduce
]
ARMS = {'torch': torch.matmul, 'kernel': matmul_bf16}


def check_results(results) -> list:
    """Every shape has a finite positive median time for both arms."""
    violations = []
    rows = {key: row for key, row in results.items() if isinstance(row, dict)}
    if len(rows) < len(SHAPES):
        violations.append('expected %d shapes, got %d' % (len(SHAPES), len(rows)))
    for key, row in rows.items():
        for arm in ARMS:
            ms = row.get(arm + '_ms')
            if ms is None:
                violations.append('%s: %s missing' % (key, arm))
            elif not (math.isfinite(ms) and ms > 0):
                violations.append('%s: %s = %r ms is not a finite positive time'
                                  % (key, arm, ms))
    return violations


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--rounds', type=int, default=5)
    parser.add_argument('--reps', type=int, default=8)
    parser.add_argument('--out', default='')
    args = parser.parse_args(argv)
    require_cuda('mm_shape_sweep')
    device = torch.device('cuda')
    card = card_line()
    print('card: %s | %d rounds x %d reps' % (card, args.rounds, args.reps), flush=True)
    results = {'card': card, 'rounds': args.rounds, 'reps': args.reps}
    for m, k, n in SHAPES:
        gen = torch.Generator(device=device).manual_seed(m + k + n)
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=device) * 0.05).to(torch.bfloat16)
        diff = float((matmul_bf16(x, w).float() - torch.matmul(x, w).float()).abs().max())
        times = {arm: [] for arm in ARMS}
        for _ in range(args.rounds):
            for arm, fn in ARMS.items():
                times[arm].append(time_ms(lambda: fn(x, w), args.reps))
        gb = (m * k + m * n + k * n) * 2 / 1e9
        row = {}
        for arm in ARMS:
            row[arm + '_ms'] = statistics.median(times[arm])
            row[arm + '_gb_s'] = gb / row[arm + '_ms'] * 1e3
        row['torch_over_kernel'] = row['torch_ms'] / row['kernel_ms']
        row['bound_ms'], row['bound_by'] = matmul_bound_ms(m, k, n)
        row['kernel_share_of_bound'] = row['bound_ms'] / row['kernel_ms']
        row['max_abs_diff'] = diff
        results['M%d_K%d_N%d' % (m, k, n)] = row
        print('M=%8d K=%4d N=%4d | torch %8.4f ms (%5.0f GB/s) | kernel %8.4f ms (%5.0f GB/s) '
              '| torch/kernel %.2fx | bound %.4f ms (%s), kernel at %.0f%% of it | max|d| %.3g'
              % (m, k, n, row['torch_ms'], row['torch_gb_s'], row['kernel_ms'],
                 row['kernel_gb_s'], row['torch_over_kernel'], row['bound_ms'], row['bound_by'],
                 100 * row['kernel_share_of_bound'], diff), flush=True)
    if args.out:
        with open(args.out, 'w') as fout:
            json.dump(results, fout, indent=2)
    print(json.dumps(results), flush=True)
    violations = check_results(results)
    if violations:
        raise SystemExit('mm_shape_sweep: ' + '; '.join(violations))
    return results


if __name__ == '__main__':
    main(sys.argv[1:])
