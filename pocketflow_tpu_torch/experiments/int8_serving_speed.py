"""int8 against bf16 serving latency on one GPU (counterpart of
experiments/int8_serving_speed.py): ResNet-50 (depthwise sites skipped: it
has none) and MobileNet-v1 (both skip modes), 224x224, batch 64, random
weights from seed 0.  Each model is served in bf16, then through
``ops/int8_ops.Int8ServingPolicy`` after post-training calibration on 2
normal batches; each mode is timed by ``tools/benchmark.py`` (100 warm-up
and 100 timed forwards over distinct staged inputs, CUDA events).

The serving bands are the JAX script's, copied verbatim
(``LOCKED_MIN_SPEEDUP``, ``check_results``): int8 must beat bf16 by 5% on
ResNet-50 and not lose on MobileNet-v1, and skipping the depthwise sites
must not be slower than quantizing them.

    python -m pocketflow_tpu_torch.experiments.int8_serving_speed [--publish]

It runs on the card; results go where synthetic_parity.py's go, and
``--publish`` writes pocketflow_tpu_torch/experiments/results/
int8_serving_speed.json.  The band's verdict is printed, not an exit code,
as the JAX script's.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from pocketflow_tpu_torch.experiments import require_cuda
from pocketflow_tpu_torch.experiments import synthetic_parity as sp

TAG = 'int8_serving_speed'
HEADER = 'INT8 SERVING BAND VIOLATIONS:'
BATCH, IMAGE_SIZE, NB_CLASSES = 64, 224, 1000
NB_WARMUP, NB_TIMED, NB_CALIB = 100, 100, 2
SERVE_FLAGS = dict(synthetic_data=True, compute_dtype='bfloat16')  # the JAX script's

# the JAX script's locked serving bands: ResNet-50 is matmul-bound, so int8
# must strictly win; MobileNet-v1 with its depthwise sites in bf16 must at
# least not lose to bf16
LOCKED_MIN_SPEEDUP = {'resnet50': 1.05, 'mobilenet_v1': 1.0}


def check_results(results):
    """Band check for the committed serving evidence."""
    violations = []
    for model, floor in LOCKED_MIN_SPEEDUP.items():
        entry = results.get(model)
        if not isinstance(entry, dict) or 'speedup' not in entry:
            violations.append('%s speedup missing from results' % model)
            continue
        if entry['speedup'] < floor:
            violations.append(
                '%s int8 speedup %.3f below locked floor %.2f'
                % (model, entry['speedup'], floor))
    mb = results.get('mobilenet_v1') or {}
    if 'int8_ms' in mb and 'int8_dw_quantized_ms' in mb \
            and mb['int8_ms'] > mb['int8_dw_quantized_ms']:
        violations.append(
            'skip-depthwise mode is SLOWER than quantizing depthwise '
            '(%.3f ms vs %.3f ms) — the policy default is wrong'
            % (mb['int8_ms'], mb['int8_dw_quantized_ms']))
    return violations


def measure(tag: str, model: torch.nn.Module, shape, skip_depthwise=None,
            nb_warmup: int = NB_WARMUP, nb_timed: int = NB_TIMED) -> dict:
    """bf16 and int8 latency of `model` at `shape` (NHWC); both skip modes
    when `skip_depthwise` is None.  Returns the JAX script's keys."""
    from pocketflow_tpu_torch.ops import int8_ops
    from pocketflow_tpu_torch.tools import benchmark as bm
    device = next(model.parameters()).device
    base = bm.calc_inference_time(model, shape, nb_warmup, nb_timed, dtype=torch.bfloat16)
    calib = [x * 0.5 for x in bm._staged_inputs(shape, torch.float32, device, seed=7,
                                                 nb=NB_CALIB)]
    act_scales = int8_ops.calibrate(model, calib)
    weight_q = int8_ops.quantize_model_weights(model)
    out = {'bf16_ms': round(base['latency_ms'], 3)}
    modes = [True, False] if skip_depthwise is None else [skip_depthwise]
    for skip in modes:
        policy = int8_ops.Int8ServingPolicy(weight_q, act_scales, skip_depthwise=skip)
        res = bm.calc_inference_time(model, shape, nb_warmup, nb_timed, dtype=torch.bfloat16,
                                     policy=policy)
        out['int8_ms' if skip else 'int8_dw_quantized_ms'] = round(res['latency_ms'], 3)
    # the speedup is the policy's default (skip) mode's; a dw-quantized-only
    # run reports its own ratio under its own key
    if 'int8_ms' in out:
        out['speedup'] = round(out['bf16_ms'] / out['int8_ms'], 3)
    if 'int8_dw_quantized_ms' in out:
        out['dw_quantized_speedup'] = round(out['bf16_ms'] / out['int8_dw_quantized_ms'], 3)
    print(json.dumps({tag: out}), flush=True)
    return out


def run(batch: int = BATCH, image_size: int = IMAGE_SIZE, nb_warmup: int = NB_WARMUP,
        nb_timed: int = NB_TIMED, device='cuda') -> dict:
    """Both models, bf16 against int8; returns the JAX script's results."""
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.nets.mobilenet import MobileNetV1
    from pocketflow_tpu_torch.nets.resnet import ResNetImageNet
    dev = torch.device(device)
    shape = (batch, image_size, image_size, 3)
    results = {'device': torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu',
               'batch': batch, '_seconds': {}}
    with FLAGS.scope(**SERVE_FLAGS):
        for tag, model, skip in (
                ('resnet50', ResNetImageNet(resnet_size=50, nb_classes=NB_CLASSES,
                                            dtype=torch.bfloat16), True),
                ('mobilenet_v1', MobileNetV1(nb_classes=NB_CLASSES, dtype=torch.bfloat16),
                 None)):
            start = time.perf_counter()
            model.reset_parameters(torch.Generator().manual_seed(0))
            results[tag] = measure(tag, model.to(dev).eval(), shape, skip, nb_warmup, nb_timed)
            results['_seconds'][tag] = round(time.perf_counter() - start, 1)
            del model
            if dev.type == 'cuda':
                torch.cuda.empty_cache()
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--publish', action='store_true',
                        help='write the results to %s' % sp.RESULTS_DIR)
    args = parser.parse_args(argv)
    require_cuda(TAG)
    from pocketflow_tpu_torch.core.cuda_timing import card_line
    card = card_line()
    print('card: %s' % card, flush=True)
    results = run()
    print(json.dumps(results, indent=1), flush=True)
    sp.finish(results, TAG, args.publish, card)
    sp.report(check_results(results), HEADER, 'int8 serving bands: int8 beats bf16')
    return results


if __name__ == '__main__':
    main()
