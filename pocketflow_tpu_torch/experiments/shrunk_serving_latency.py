"""Serving latency of a physically shrunk channel-pruned ResNet-50 on one GPU
(counterpart of experiments/shrunk_serving_latency.py).

ResNet-50 (1,001 classes, bf16, random weights from seed 0) gets the first
half of the input channels of every conv and dense kernel zeroed (the stem
conv, on 3 channels, stays whole): the dense net with zeros.  The
residual-aware shrink (``tools/shrink_graph.py``: ``capture_conv_graph``,
``shrink_residual_aware``, ``width_map_from_packed``,
``variables_from_packed``) then removes those channels across the residual
merges, and the width-mapped net serves the packed parameters.  It prints
the logits' max |delta| between the shrunk net and the dense net with zeros,
the parameters before and after, and both latencies at batch 64 over 30
forwards after one (``tools/benchmark.py``).

    python -m pocketflow_tpu_torch.experiments.shrunk_serving_latency

It runs on the card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pocketflow_tpu_torch.experiments import require_cuda

BATCH, IMAGE_SIZE, NB_CLASSES, NB_TIMED = 64, 224, 1001, 30
SHRINK_FLAGS = dict(synthetic_data=True, compute_dtype='bfloat16', batch_size=64,
                    batch_size_eval=64)  # the JAX script's


def zero_half(node: dict):
    """Zero the first half of the input channels of every conv kernel with
    more than 3 (HWIO) and of every dense kernel, in place in a numpy tree."""
    for key, child in node.items():
        if isinstance(child, dict):
            if 'kernel' in child:
                arr = np.array(child['kernel'])
                if arr.ndim == 4 and arr.shape[2] > 3:
                    arr[:, :, :arr.shape[2] // 2, :] = 0.0
                elif arr.ndim == 2:
                    arr[:arr.shape[0] // 2, :] = 0.0
                child['kernel'] = arr
            else:
                zero_half(child)


def run(batch: int = BATCH, image_size: int = IMAGE_SIZE, nb_timed: int = NB_TIMED,
        device='cuda', dtype=torch.bfloat16) -> dict:
    """Shrink and serve; returns {'logits_max_delta', 'logits_max',
    'params_dense', 'params_shrunk', 'dense_ms', 'shrunk_ms', 'speedup'}."""
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.core.bridge import load_jax_numpy, to_jax_numpy
    from pocketflow_tpu_torch.main import register_flags
    from pocketflow_tpu_torch.nets.resnet import ResNetImageNet
    from pocketflow_tpu_torch.tools import benchmark as bm
    from pocketflow_tpu_torch.tools import shrink_graph as sg
    dev = torch.device(device)
    shape = (batch, image_size, image_size, 3)
    register_flags()  # the batch flags are the datasets'
    with FLAGS.scope(**SHRINK_FLAGS):
        dense = ResNetImageNet(resnet_size=50, nb_classes=NB_CLASSES, dtype=dtype)
        dense.reset_parameters(torch.Generator().manual_seed(0))
        params, stats = to_jax_numpy(dense)
        zero_half(params)
        dense = load_jax_numpy(dense, params, stats).to(dev).eval()

        graph = sg.capture_conv_graph(dense, shape, dtype=dtype)
        packed, _ = sg.shrink_residual_aware(params, stats, graph)
        small = dense.clone(width_map=sg.width_map_from_packed(packed))
        shrunk = sg.variables_from_packed(packed)
        small = load_jax_numpy(small, shrunk['params'], shrunk['batch_stats']).to(dev).eval()

        gen = torch.Generator(device=dev).manual_seed(1)
        images = torch.randn(shape, generator=gen, device=dev).to(dtype)
        with torch.no_grad():
            a, b = dense(images).float(), small(images).float()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise RuntimeError('non-finite logits')
        delta = float((a - b).abs().max())
        dense_ms = bm.calc_inference_time(dense, shape, 1, nb_timed, dtype=dtype)['latency_ms']
        shrunk_ms = bm.calc_inference_time(small, shape, 1, nb_timed, dtype=dtype)['latency_ms']
    out = {'logits_max_delta': delta, 'logits_max': float(a.abs().max()),
           'params_dense': sum(p.numel() for p in dense.parameters()),
           'params_shrunk': sum(p.numel() for p in small.parameters()),
           'dense_ms': dense_ms, 'shrunk_ms': shrunk_ms, 'speedup': dense_ms / shrunk_ms}
    print('logits max delta (%s): %.3g (largest logit %.3g)'
          % (str(dtype).split('.')[-1], delta, out['logits_max']), flush=True)
    print('params: %.1fM -> %.1fM' % (out['params_dense'] / 1e6, out['params_shrunk'] / 1e6))
    print('latency bs%d: dense %.2f ms  shrunk %.2f ms  speedup %.2fx'
          % (batch, dense_ms, shrunk_ms, out['speedup']), flush=True)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.parse_args(argv)
    require_cuda('shrunk_serving_latency')
    from pocketflow_tpu_torch.core.cuda_timing import card_line
    out = dict(run(), card=card_line())
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
