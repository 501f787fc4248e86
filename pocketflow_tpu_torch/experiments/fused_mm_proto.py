"""A/B of the fused 1x1-conv matmul with a BN prologue and a statistics
epilogue (counterpart of experiments/fused_mm_proto.py), on one GPU.

    python -m pocketflow_tpu_torch.experiments.fused_mm_proto [--reps 20] [--out FILE]

At one ResNet-50 shape (M rows = N*H*W, K in-channels, N out-channels; the
environment variables M, K and N override the defaults 256*56*56, 256 and
64), with x ~ N(0, 1) and w ~ 0.05 N(0, 1) in bf16, scale 1.1 and shift 0.1:

  A) the library chain: z = relu(f32(x) * scale + shift), elementwise torch
     ops, cast to bf16 (the TPU's default-precision dot took z in bf16 too);
     y = torch.matmul(z, w) (cuBLAS, bf16 out); s and ss summed from the bf16
     y, as the JAX script's XLA arm sums them;
  B) ``bn_relu_matmul_stats``: all of A in one pass over x (csrc/matmul.cu),
     its sums taken from the fp32 accumulator as the TPU kernel takes them.

Prints the relative error of B's sums against A's, both times (CUDA events,
after a synchronize), the rate against the least bytes the op must move,
(M*K + M*N)*2, and the ratio A/B.  The last line is the results as JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

from pocketflow_tpu_torch.core.cuda_timing import card_line, time_ms
from pocketflow_tpu_torch.experiments import require_cuda
from pocketflow_tpu_torch.ops.matmul import bn_relu_matmul_stats

M = int(os.environ.get('M', 256 * 56 * 56))
K = int(os.environ.get('K', 256))
N = int(os.environ.get('N', 64))
SCALE, SHIFT = 1.1, 0.1
# B sums y32 where A sums bf16(y): the two differ by the bf16 rounding of y
MAX_SUMS_REL_ERR = 1e-3


def library_chain(x, w, scale, shift):
    z = torch.relu(x.float() * scale + shift).to(torch.bfloat16)
    y = torch.matmul(z, w)
    y32 = y.float()
    return y, y32.sum(0), y32.square().sum(0)


def inputs(m, k, n, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=device) * 0.05).to(torch.bfloat16)
    scale = torch.full((k,), SCALE, device=device)
    shift = torch.full((k,), SHIFT, device=device)
    return x, w, scale, shift


def check_results(results) -> list:
    """Violations of the results' sanity: both arms timed, finite positive
    times, B's sums within MAX_SUMS_REL_ERR of A's."""
    violations = []
    for key in ('chain_ms', 'fused_ms', 'sums_rel_err'):
        if key not in results:
            violations.append('%s missing' % key)
    for key in ('chain_ms', 'fused_ms'):
        value = results.get(key)
        if value is not None and not (math.isfinite(value) and value > 0):
            violations.append('%s = %r is not a finite positive time' % (key, value))
    err = results.get('sums_rel_err')
    if err is not None and not err <= MAX_SUMS_REL_ERR:
        violations.append('sums_rel_err %r above %g' % (err, MAX_SUMS_REL_ERR))
    return violations


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--reps', type=int, default=20)
    parser.add_argument('--out', default='')
    args = parser.parse_args(argv)
    require_cuda('fused_mm_proto')
    device = torch.device('cuda')
    x, w, scale, shift = inputs(M, K, N, device)
    ya, sa, ssa = library_chain(x, w, scale, shift)
    yb, sb, ssb = bn_relu_matmul_stats(x, w, scale, shift)
    err = float((sa - sb).abs().max() / (sa.abs().max() + 1e-9))
    ss_err = float(((ssa - ssb).abs() / ssa).max())
    y_diff = int((ya != yb).sum())
    print('rel err on sums: %.2e (sum of squares: %.2e); y elements that differ: %d of %d'
          % (err, ss_err, y_diff, ya.numel()))

    t_a = time_ms(lambda: library_chain(x, w, scale, shift), args.reps)
    t_b = time_ms(lambda: bn_relu_matmul_stats(x, w, scale, shift), args.reps)
    bytes_min = (M * K + M * N) * 2
    card = card_line()
    print('M=%d K=%d N=%d on %s' % (M, K, N, card))
    print('library chain: %8.4f ms  (%.0f GB/s effective vs %d MB min)'
          % (t_a, bytes_min / t_a / 1e6, bytes_min // 2 ** 20))
    print('fused kernel : %8.4f ms  (%.0f GB/s effective)' % (t_b, bytes_min / t_b / 1e6))
    print('speedup: %.2fx' % (t_a / t_b))
    results = {'M': M, 'K': K, 'N': N, 'card': card, 'reps': args.reps,
               'sums_rel_err': err, 'sumsq_rel_err': ss_err, 'y_elements_differ': y_diff,
               'chain_ms': t_a, 'fused_ms': t_b, 'chain_gb_s': bytes_min / t_a / 1e6,
               'fused_gb_s': bytes_min / t_b / 1e6, 'speedup': t_a / t_b}
    if args.out:
        with open(args.out, 'w') as fout:
            json.dump(results, fout, indent=2)
    print(json.dumps(results), flush=True)
    violations = check_results(results)
    if violations:
        raise SystemExit('fused_mm_proto: ' + '; '.join(violations))
    return results


if __name__ == '__main__':
    main(sys.argv[1:])
