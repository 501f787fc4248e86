"""Which shapes cuBLASLt's int8 GEMM (``torch._int_mm``) takes on this card:
the record behind ``ops/int8_ops.int8_matmul``'s padding, on one GPU.

    python -m pocketflow_tpu_torch.experiments.int_mm_probe [--out FILE]

For A [M, K] row-major and B [K, N] given row-major or column-major (the
transpose of an [N, K] tensor), at M in {17, 40, 200704} and every K and N
in a grid of multiples of 8, ``torch._int_mm`` either refuses the shape
(CUBLAS_STATUS_NOT_SUPPORTED) or runs; a product that runs is checked
against the int64 product on the CPU (its first 64 rows).  Prints the
refused and the wrong (M, K, N) of each layout (all of them in --out); the
last line is the counts as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from pocketflow_tpu_torch.core.cuda_timing import card_line
from pocketflow_tpu_torch.experiments import require_cuda

ROWS = (17, 40, 200704)
DEPTHS = (8, 16, 24, 32, 40, 64, 96, 256, 576)
WIDTHS = tuple(range(8, 1025, 8))


def probe(m: int, k: int, n: int, column_major_b: bool) -> str:
    gen = torch.Generator(device='cuda').manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, device='cuda', dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=gen, device='cuda', dtype=torch.int8).t()
    if not column_major_b:
        b = b.contiguous()
    try:
        out = torch._int_mm(a, b)
        torch.cuda.synchronize()
    except RuntimeError as err:
        if 'NOT_SUPPORTED' not in str(err):
            raise
        return 'refused'
    want = (a[:64].cpu().long() @ b.cpu().long()).int()
    return 'ok' if torch.equal(out[:64].cpu(), want) else 'wrong'


def main(argv=None):
    require_cuda('int_mm_probe')
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    results = {'card': card_line(), 'torch': torch.__version__, 'cuda': torch.version.cuda}
    for layout in ('column-major B', 'row-major B'):
        found = {'refused': [], 'wrong': [], 'ok': 0}
        for m in ROWS:
            for k in DEPTHS:
                for n in WIDTHS:
                    verdict = probe(m, k, n, layout == 'column-major B')
                    if verdict == 'ok':
                        found['ok'] += 1
                    else:
                        found[verdict].append((m, k, n))
        print('%s: %d shapes run, %d refused, %d wrong; refused (M, K, N): %s | %s'
              % (layout, found['ok'], len(found['refused']), len(found['wrong']),
                 found['refused'][:40], results['card']), flush=True)
        results[layout] = found
    if args.out:
        with open(args.out, 'w') as fout:
            fout.write(json.dumps(results) + '\n')
    print(json.dumps({key: ({'ok': value['ok'], 'refused': len(value['refused']),
                             'wrong': len(value['wrong'])} if isinstance(value, dict) else value)
                      for key, value in results.items()}))
    return results


if __name__ == '__main__':
    main(sys.argv[1:])
