"""Run one cell of the benchmark and print its result as the last line of
standard output.

    python3 -m pfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``.  Exits with a
non-zero code and prints no result when no card is present or fewer than
the cell asks for, when the program cannot be imported, or when JAX, a JAX
library or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

START = time.perf_counter()  # the process's start, as near as Python lets us read it

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from pfbench import harness  # noqa: E402


def parse(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool, root: str = '.',
             device: str = 'cuda', start: float = START, sizes=None) -> dict:
    """The cell's result (the keys of the printed line).  `device` 'cpu' and
    `sizes` (overrides of the configuration and traffic) serve the tests."""
    loaded = harness.load_cell(root, name, sizes)
    driver = importlib.import_module('pfbench.drivers.' + loaded['traffic']['driver'])
    return driver.run(loaded, seed=seed, seconds=seconds, trace=trace, device=device,
                      start=start)


def main(argv=None) -> int:
    args = parse(argv)
    loaded = harness.load_cell('.', args.workload)
    chips = int(loaded['cell']['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.note('needs %d CUDA device(s); torch.cuda.is_available() is %s, %d found'
                     % (chips, torch.cuda.is_available(),
                        torch.cuda.device_count() if torch.cuda.is_available() else 0))
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        harness.note('JAX or the JAX package is loaded: %s' % ', '.join(found))
        return 4
    harness.report_checks(result['checks'])
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
