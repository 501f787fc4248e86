"""Float against int8 TFLite latency of real backbones on the host CPU
(counterpart of experiments/tflite_latency.py; a host analogue of the
reference's phone table).

MobileNet-v1 and -v2, and on request ResNet-18, at 224x224 (random weights
from seed 0, fp32) go through ``tools/export_tflite.py`` to a float and a
full-int8 TFLite artifact (uint8 input, calibrated on the sample), and each
is timed in the TFLite interpreter: 100 warm-up and 100 timed invocations on
one thread (one phone core).  It prints each latency, the speedup and both
artifacts' sizes, with the host's CPU model and the thread count.

    python -m pocketflow_tpu_torch.experiments.tflite_latency [model ...]

It needs TensorFlow (the converter and the interpreter are host programs)
and no GPU: it runs on the host CPU by nature.
"""

from __future__ import annotations

import json
import platform
import sys
from typing import Sequence

import numpy as np
import torch

MODELS = ('mobilenet_v1', 'mobilenet_v2', 'resnet_18')
DEFAULT_MODELS = ('mobilenet_v1', 'mobilenet_v2')
IMAGE_SIZE, NB_CLASSES = 224, 1000
NB_WARMUP, NB_TIMED, NB_THREADS = 100, 100, 1


def host_cpu() -> str:
    """The host CPU's model name, as the kernel reports it."""
    try:
        with open('/proc/cpuinfo') as fin:
            for line in fin:
                if line.startswith('model name'):
                    return line.split(':', 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def build(name: str, image_size: int = IMAGE_SIZE, depth_mult: float = 1.0):
    """(model, sample): `name`'s net in fp32 eval mode, random weights from
    seed 0, and one NHWC sample of uniform [0, 1) pixels from seed 0."""
    from pocketflow_tpu_torch.nets.mobilenet import MobileNetV1, MobileNetV2
    from pocketflow_tpu_torch.nets.resnet import ResNetImageNet
    if name == 'mobilenet_v1':
        model = MobileNetV1(nb_classes=NB_CLASSES, depth_mult=depth_mult, dtype=torch.float32)
    elif name == 'mobilenet_v2':
        model = MobileNetV2(nb_classes=NB_CLASSES, depth_mult=depth_mult, dtype=torch.float32)
    elif name == 'resnet_18':
        model = ResNetImageNet(resnet_size=18, nb_classes=NB_CLASSES, dtype=torch.float32)
    else:
        raise ValueError('unknown model %r (one of %s)' % (name, MODELS))
    model.reset_parameters(torch.Generator().manual_seed(0))
    sample = np.random.default_rng(0).random((1, image_size, image_size, 3)).astype(np.float32)
    return model.eval(), sample


def run(models: Sequence[str] = DEFAULT_MODELS, image_size: int = IMAGE_SIZE,
        nb_warmup: int = NB_WARMUP, nb_timed: int = NB_TIMED, nb_threads: int = NB_THREADS,
        depth_mult: float = 1.0) -> dict:
    """{model: {'fp32_ms', 'int8_ms', 'speedup', 'fp32_bytes', 'int8_bytes'},
    'host': {'cpu', 'threads'}}."""
    from pocketflow_tpu_torch.tools import export_tflite as tfl
    results = {}
    for name in models:
        model, sample = build(name, image_size, depth_mult)
        blob_f = tfl.convert_to_tflite(model, None, sample, quantize='none')
        blob_q = tfl.convert_to_tflite(model, None, sample, quantize='int8', input_uint8=True)
        lat_f = tfl.measure_latency(blob_f, nb_warmup, nb_timed, nb_threads)
        lat_q = tfl.measure_latency(blob_q, nb_warmup, nb_timed, nb_threads)
        results[name] = {
            'fp32_ms': round(lat_f['mean_ms'], 2),
            'int8_ms': round(lat_q['mean_ms'], 2),
            'speedup': round(lat_f['mean_ms'] / lat_q['mean_ms'], 2),
            'fp32_bytes': len(blob_f), 'int8_bytes': len(blob_q),
        }
        print(name, json.dumps(results[name]), flush=True)
    results['host'] = {'cpu': host_cpu(), 'threads': nb_threads}
    print(json.dumps({'host': results['host']}), flush=True)
    return results


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    return run(argv or DEFAULT_MODELS)


if __name__ == '__main__':
    main()
