"""Chained A/B of 1x1-conv lowerings at ResNet-50's trunk widths
(counterpart of experiments/conv1x1_ab.py), on one GPU.

    python -m pocketflow_tpu_torch.experiments.conv1x1_ab [--reps 4] [--out FILE]

At square channel shapes (C in = C out, so the chain keeps its shape), each
lowering runs k_iters = max(4, 6e9 / bytes per iteration) times in a row
through a Python loop, on x = 0.5 and the identity weight in bf16:

  conv   - F.conv2d, 1x1, on the channels-last activation (cuDNN)
  dot    - torch.matmul on its [M, C] view (cuBLAS)
  kernel - matmul_bf16 on the same view (csrc/matmul.cu)

Each arm is warmed with two chains, then `--reps` chains are timed with CUDA
events.  The rate counts one read and one write of the activation per
iteration.  The arms' inputs and outputs follow the port's layouts: the
activation is an NCHW tensor in the channels-last memory format (the JAX
script's NHWC), the conv weight HWIO [1, 1, C, C], the matmul weight [C, C].
Results go to --out (default: conv1x1_ab.json in a directory under the
system's temporary directory), never to the JAX package's experiments/results.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

import torch
import torch.nn.functional as F

from pocketflow_tpu_torch.core.cuda_timing import card_line, time_ms
from pocketflow_tpu_torch.experiments import require_cuda
from pocketflow_tpu_torch.ops.matmul import matmul_bf16

# (spatial, channels): square-channel 1x1 stand-ins for the ResNet-50 trunk
SHAPES = [
    ((256, 56, 56), 256),
    ((256, 28, 28), 512),
    ((256, 14, 14), 1024),
]
N_TIMED = 4
ARMS = ('conv', 'dot', 'kernel')


def default_out() -> str:
    return os.path.join(tempfile.gettempdir(), 'pocketflow_tpu_torch', 'conv1x1_ab.json')


def k_iters_for(spatial, c) -> int:
    n, h, wd = spatial
    bytes_per_iter = 2.0 * n * h * wd * c * 2
    return max(4, int(6e9 / bytes_per_iter))


def make_conv(spatial, c, w_hwio, k_iters):
    w_oihw = w_hwio.permute(3, 2, 0, 1).contiguous()

    def step(v):
        for _ in range(k_iters):
            v = F.conv2d(v, w_oihw)
        return v
    return step


def _make_matmul(spatial, c, w2d, k_iters, matmul):
    n, h, wd = spatial

    def step(v):
        for _ in range(k_iters):
            m2d = v.permute(0, 2, 3, 1).reshape(n * h * wd, c)
            v = matmul(m2d, w2d).reshape(n, h, wd, c).permute(0, 3, 1, 2)
        return v
    return step


def make_dot(spatial, c, w2d, k_iters):
    return _make_matmul(spatial, c, w2d, k_iters, torch.matmul)


def make_kernel(spatial, c, w2d, k_iters):
    return _make_matmul(spatial, c, w2d, k_iters, matmul_bf16)


def make_arms(spatial, c, w2d, k_iters):
    """{arm: step} with the weight [C, C] given in the JAX script's layout."""
    return {'conv': make_conv(spatial, c, w2d.reshape(1, 1, c, c), k_iters),
            'dot': make_dot(spatial, c, w2d, k_iters),
            'kernel': make_kernel(spatial, c, w2d, k_iters)}


def check_results(results) -> list:
    """Every shape has a finite positive rate for all three arms."""
    violations = []
    rows = {key: row for key, row in results.items() if isinstance(row, dict)}
    if len(rows) < len(SHAPES):
        violations.append('expected >= %d shapes, got %d' % (len(SHAPES), len(rows)))
    for key, row in rows.items():
        for arm in ARMS:
            rate = row.get(arm)
            if rate is None:
                violations.append('%s: %s missing' % (key, arm))
            elif not (math.isfinite(rate) and rate > 0):
                violations.append('%s: %s = %r GB/s is not a finite positive rate'
                                  % (key, arm, rate))
    return violations


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--reps', type=int, default=N_TIMED)
    parser.add_argument('--out', default=default_out())
    args = parser.parse_args(argv)
    require_cuda('conv1x1_ab')
    device = torch.device('cuda')
    card = card_line()
    print('card: %s' % card, flush=True)
    results = {'card': card, 'reps': args.reps}
    for spatial, c in SHAPES:
        n, h, wd = spatial
        k_iters = k_iters_for(spatial, c)
        x = torch.full((n, c, h, wd), 0.5, dtype=torch.bfloat16, device=device)
        x = x.contiguous(memory_format=torch.channels_last)
        w = torch.eye(c, device=device).mul(0.999).to(torch.bfloat16)
        gb = 2.0 * n * h * wd * c * 2 * k_iters / 1e9
        row = {'k_iters': k_iters}
        outputs = {}
        for arm, step in make_arms(spatial, c, w, k_iters).items():
            outputs[arm] = step(x)
            ms = time_ms(lambda: step(x), args.reps)
            row[arm] = gb / ms * 1e3
        # identity weight: every arm's chain leaves x as it was
        row['max_abs_diff_vs_conv'] = max(
            float((outputs[arm].float() - outputs['conv'].float()).abs().max()) for arm in ARMS)
        key = 'M%d_C%d' % (n * h * wd, c)
        results[key] = row
        print(json.dumps({key: row}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as fout:
        json.dump(results, fout, indent=2)
    print('results written to %s' % args.out, flush=True)
    violations = check_results(results)
    if violations:
        raise SystemExit('conv1x1_ab: ' + '; '.join(violations))
    return results


if __name__ == '__main__':
    main(sys.argv[1:])
