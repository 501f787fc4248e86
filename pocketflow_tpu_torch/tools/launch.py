"""Launch N data-parallel ranks on this host (counterpart of
scripts/run_multihost.sh and __graft_entry__.dryrun_multichip).

Each rank is a process with torchrun's environment (WORLD_SIZE, RANK,
LOCAL_RANK) that joins one process group through a file rendezvous (a
``FileStore`` in a fresh directory, so that concurrent launches never share a
port), runs its target and leaves the group.  A rank that does not finish
within the timeout fails the launch, and every rank is then killed.

    # main.py on 2 ranks, gloo on the CPU (--device=cuda: NCCL, a card a rank)
    python -m pocketflow_tpu_torch.tools.launch --nproc_per_node=2 --device=cpu -- \\
        --model=convnet_at_fmnist --synthetic_data --nb_epochs_rat=0.01 --enbl_multi_gpu
    # the same with torchrun, on the cards
    torchrun --nproc_per_node=2 -m pocketflow_tpu_torch.main ... --enbl_multi_gpu

``spawn(target, nprocs, kwargs)`` runs ``module:function(**kwargs)`` on every
rank and returns the ranks' results; ``dryrun_multichip(n)`` takes one
full-precision ConvNet @ FMNIST step on n gloo CPU ranks and prints its
accuracy.
"""

from __future__ import annotations

import argparse
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMEOUT_S = 120.0


def _tail(path: str, nb_bytes: int = 4000) -> str:
    with open(path, 'rb') as fin:
        fin.seek(0, os.SEEK_END)
        fin.seek(max(0, fin.tell() - nb_bytes))
        return fin.read().decode(errors='replace')


def spawn(target: str, nprocs: int, kwargs: Optional[Dict[str, Any]] = None,
          backend: str = 'gloo', timeout: Optional[float] = TIMEOUT_S,
          work_dir: Optional[str] = None,
          paths: Sequence[str] = (), threads: int = 2) -> List[Any]:
    """Run ``module:function(**kwargs)`` in `nprocs` ranks of one `backend`
    group and return each rank's result (picklable by ``torch.save``), in
    rank order.  `paths` are prepended to the ranks' PYTHONPATH (the repo
    is always on it); each rank uses `threads` CPU threads.  Raises if a rank
    fails or the ranks are not done within `timeout` seconds (None: no limit)."""
    import torch
    owned = work_dir is None
    work_dir = tempfile.mkdtemp(prefix='pf_launch_') if owned else work_dir
    os.makedirs(work_dir, exist_ok=True)
    torch.save(kwargs or {}, os.path.join(work_dir, 'kwargs.pt'))
    store = os.path.join(work_dir, 'store-%d' % time.time_ns())
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [*paths, REPO] + ([env['PYTHONPATH']] if env.get('PYTHONPATH') else []))
    procs = []
    for rank in range(nprocs):
        log = open(os.path.join(work_dir, 'rank%d.log' % rank), 'w')
        procs.append((subprocess.Popen(
            [sys.executable, '-m', 'pocketflow_tpu_torch.tools.launch', '--_worker',
             '--work_dir', work_dir, '--target', target, '--backend', backend,
             '--store', store, '--threads', str(threads)],
            env={**env, 'WORLD_SIZE': str(nprocs), 'RANK': str(rank), 'LOCAL_RANK': str(rank)},
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO), log))
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                proc.wait(timeout=None if deadline is None
                          else max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise TimeoutError('rank %d of %s did not finish within %.0f s:\n%s'
                                   % (rank, target, timeout,
                                      _tail(os.path.join(work_dir, 'rank%d.log' % rank))))
        for rank, (proc, _) in enumerate(procs):
            if proc.returncode != 0:
                raise RuntimeError('rank %d of %s exited with %d:\n%s'
                                   % (rank, target, proc.returncode,
                                      _tail(os.path.join(work_dir, 'rank%d.log' % rank))))
        return [torch.load(os.path.join(work_dir, 'result%d.pt' % rank), weights_only=False)
                for rank in range(nprocs)]
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        if owned:
            shutil.rmtree(work_dir, ignore_errors=True)


def _worker(work_dir: str, target: str, backend: str, store: str, threads: int):
    import torch
    import torch.distributed as dist
    if threads > 0:
        torch.set_num_threads(threads)
    world, rank = int(os.environ['WORLD_SIZE']), int(os.environ['RANK'])
    if backend == 'nccl':
        torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
    dist.init_process_group(backend, init_method='file://' + store, world_size=world,
                            rank=rank)
    try:
        module, _, name = target.partition(':')
        fn = getattr(importlib.import_module(module), name)
        kwargs = torch.load(os.path.join(work_dir, 'kwargs.pt'), weights_only=False)
        result = fn(**kwargs)
        torch.save(result, os.path.join(work_dir, 'result%d.pt' % rank))
    finally:
        dist.destroy_process_group()


def run_main(argv: List[str], device: str = 'cpu'):
    """A rank's ``main.main(argv, device)``; returns nothing."""
    from pocketflow_tpu_torch import main as main_lib
    main_lib.main(list(argv), device=device)


def _dryrun_rank(work_dir: str) -> float:
    """One full-precision ConvNet @ FMNIST train step on this rank (batch 4
    a rank, fp32, synthetic data): the step's accuracy over the global batch."""
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    with FLAGS.scope(batch_size=4, nb_smpls_train=256, nb_smpls_eval=64, batch_size_eval=4,
                     compute_dtype='float32', synthetic_data=True,
                     save_path=os.path.join(work_dir, 'models', 'model.ckpt')):
        learner = FullPrecLearner(None, ModelHelper(), device='cpu')
        state, tx, _ = learner.init_state()
        step = learner.build_train_step(tx)
        batch = learner.put_batch(next(learner.dataset_train.build()))
        state, metrics = step(state, batch, learner.generator(0))
        return learner.global_scalars(metrics)['accuracy']


def dryrun_multichip(nb_ranks: int = 2) -> float:
    """One train step over `nb_ranks` gloo CPU ranks; prints and returns
    its accuracy."""
    import math
    with tempfile.TemporaryDirectory(prefix='pf_dryrun_') as work_dir:
        accs = spawn('pocketflow_tpu_torch.tools.launch:_dryrun_rank', nb_ranks,
                     {'work_dir': work_dir}, work_dir=work_dir)
    if len(set(accs)) != 1 or not math.isfinite(accs[0]):
        raise RuntimeError('dryrun_multichip(%d): ranks disagree or diverge: %s'
                           % (nb_ranks, accs))
    print('dryrun_multichip(%d) OK: world=%d backend=gloo accuracy=%.3f'
          % (nb_ranks, nb_ranks, accs[0]))
    return accs[0]


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--nproc_per_node', type=int, default=2)
    parser.add_argument('--device', default='cuda', help='cuda (NCCL) or cpu (gloo)')
    parser.add_argument('--timeout', type=float, default=None,
                        help='seconds the ranks may take (default: no limit)')
    parser.add_argument('--_worker', action='store_true', help=argparse.SUPPRESS)
    parser.add_argument('--work_dir', help=argparse.SUPPRESS)
    parser.add_argument('--target', help=argparse.SUPPRESS)
    parser.add_argument('--backend', help=argparse.SUPPRESS)
    parser.add_argument('--store', help=argparse.SUPPRESS)
    parser.add_argument('--threads', type=int, default=0, help=argparse.SUPPRESS)
    argv = list(sys.argv[1:] if argv is None else argv)
    main_argv = argv[argv.index('--') + 1:] if '--' in argv else []
    args = parser.parse_args(argv[:argv.index('--')] if '--' in argv else argv)
    if args._worker:
        _worker(args.work_dir, args.target, args.backend, args.store, args.threads)
        return
    backend = 'nccl' if args.device == 'cuda' else 'gloo'
    spawn('pocketflow_tpu_torch.tools.launch:run_main', args.nproc_per_node,
          {'argv': main_argv, 'device': args.device}, backend=backend,
          timeout=args.timeout, threads=0)


if __name__ == '__main__':
    main()
