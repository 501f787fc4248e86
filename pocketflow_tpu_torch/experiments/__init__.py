"""Experiments on one GPU: A/B runs of the port's hand-written matmul kernels
(counterparts of the JAX package's experiments/fused_mm_proto.py,
conv1x1_ab.py and mm_shape_sweep.py) and the int8 GEMM's shape probe
(int_mm_probe.py).  Each is an entry point,
``python -m pocketflow_tpu_torch.experiments.<name>``, whose ``main(argv)``
also returns its results, and each needs a CUDA device."""

import torch


def require_cuda(name: str):
    if not torch.cuda.is_available():
        raise SystemExit('%s: needs a CUDA device (torch.cuda.is_available() is False)' % name)
