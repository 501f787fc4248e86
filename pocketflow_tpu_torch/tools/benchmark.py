"""Inference-latency microbenchmark (counterpart of
pocketflow_tpu/tools/benchmark.py).

Protocol (the reference's calc_inference_time: 100 warm-up + 100 timed
runs): forwards over DISTINCT pre-staged inputs on the model's device, a
warm-up, then the timed calls.  On the card the timed window is two CUDA
events around the calls, read after a synchronize; on the CPU it is the host
clock.  Every result names the device it ran on.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from pocketflow_tpu_torch.core.metrics import get_logger
from pocketflow_tpu_torch.nn.layers import CompressionPolicy, compression

log = get_logger()


def _staged_inputs(input_shape, dtype, device, seed: int = 11, nb: int = 4):
    gen = torch.Generator(device=device)
    out = []
    for i in range(nb):
        gen.manual_seed(seed + i)
        out.append(torch.randn(tuple(input_shape), generator=gen, device=device).to(dtype))
    return out


def _time_forward(model, policy, inputs, nb_warmup: int, nb_timed: int) -> float:
    """Seconds for nb_timed forwards after nb_warmup."""
    device = inputs[0].device

    def forward(i):
        with compression(policy):
            return model(inputs[i % len(inputs)])

    with torch.no_grad():
        for i in range(nb_warmup + 1):
            forward(i)
        if device.type != 'cuda':
            start = time.perf_counter()
            for i in range(nb_timed):
                forward(i)
            return time.perf_counter() - start
        torch.cuda.synchronize(device)
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        for i in range(nb_timed):
            forward(i)
        end.record()
        torch.cuda.synchronize(device)
        return begin.elapsed_time(end) / 1e3


def calc_inference_time(model: torch.nn.Module, input_shape, nb_warmup: int = 100,
                        nb_timed: int = 100, dtype=torch.float32,
                        policy: Optional[CompressionPolicy] = None) -> Dict[str, float]:
    """{'latency_ms', 'throughput_per_sec', 'device'} of the eval forward
    (under `policy`, if any) at `input_shape`."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    elapsed = _time_forward(model, policy, _staged_inputs(input_shape, dtype, device),
                            nb_warmup, nb_timed)
    model.train(was_training)
    result = {'latency_ms': elapsed / nb_timed * 1e3,
              'throughput_per_sec': input_shape[0] * nb_timed / elapsed,
              'device': torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}
    log.info('inference on %s: %.3f ms/batch | %.1f samples/sec', result['device'],
             result['latency_ms'], result['throughput_per_sec'])
    return result


def calc_quantized_inference_time(model: torch.nn.Module, input_shape,
                                  nb_calib_batches: int = 2, nb_warmup: int = 20,
                                  nb_timed: int = 50, dtype=torch.float32):
    """Float against int8-serving latency (the reference's 32 -> 8 bit
    latency comparison).  Activation scales come from `nb_calib_batches`
    normal batches.  Returns {'float': {...}, 'int8': {...}, 'speedup': x}."""
    from pocketflow_tpu_torch.ops import int8_ops
    device = next(model.parameters()).device
    base = calc_inference_time(model, input_shape, nb_warmup, nb_timed, dtype)
    calib = _staged_inputs(input_shape, torch.float32, device, seed=7, nb=nb_calib_batches)
    policy = int8_ops.Int8ServingPolicy(int8_ops.quantize_model_weights(model),
                                        int8_ops.calibrate(model, calib))
    int8_res = calc_inference_time(model, input_shape, nb_warmup, nb_timed, dtype, policy)
    speedup = base['latency_ms'] / max(int8_res['latency_ms'], 1e-9)
    log.info('int8 serving: %.3f ms vs %.3f ms float (%.2fx)', int8_res['latency_ms'],
             base['latency_ms'], speedup)
    return {'float': base, 'int8': int8_res, 'speedup': speedup}
