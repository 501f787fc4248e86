"""Weights and inputs made from the seed, on the device, in a few large
calls, keyed by the program's state-dict names (a layer ``a/b`` holds
``a.b.kernel``; its BN ``c/d`` holds ``c.d.bn.scale``, ``.bias``, ``.mean``,
``.var``).  Both sides are handed the same tensors: the program loads them
(strictly: its model has to have exactly these names and shapes), the
reference reads them."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

# seed streams, apart from one another
WEIGHTS, TRAIN_DATA, CALIBRATION, REQUESTS, FLIPS = 1, 2, 3, 4, 5


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one stream of a run's draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 8 + stream) % (2 ** 63))
    return gen


def kernel_shape(layer: Dict) -> List[int]:
    """HWIO for a conv (one input channel for a depthwise one), [in, out]
    for a dense layer."""
    if layer.get('dense'):
        return [layer['in'][1], layer['out']]
    cin = 1 if layer.get('depthwise') else layer['in'][1]
    return [layer['k'], layer['k'], cin, layer['out']]


def key(path: str) -> str:
    return path.replace('/', '.')


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's parameters and BN statistics in fp32: He normal kernels
    (std sqrt(2 / fan_out), fan_out = kh kw c_out), lecun normal dense
    kernels (std sqrt(1 / fan_in)), zero biases, BN scale 1, bias 0, mean 0,
    variance 1.  One normal draw for all kernels."""
    shapes = [kernel_shape(layer) for layer in cfg['layers']]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device), device=device)
    out, at = {}, 0
    for layer, shape, size in zip(cfg['layers'], shapes, sizes):
        if layer.get('dense'):
            std = math.sqrt(1.0 / shape[0])
        else:
            std = math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        out[key(layer['p']) + '.kernel'] = flat[at:at + size].view(shape).mul(std)
        at += size
        if layer.get('bias'):
            out[key(layer['p']) + '.bias'] = torch.zeros(layer['out'], device=device)
        if layer.get('bn'):
            name = key(layer['bn']) + '.bn.'
            c = layer['out']
            out[name + 'scale'] = torch.ones(c, device=device)
            out[name + 'bias'] = torch.zeros(c, device=device)
            out[name + 'mean'] = torch.zeros(c, device=device)
            out[name + 'var'] = torch.ones(c, device=device)
    return out


def train_batches(cfg: Dict, batch: int, count: int, seed: int, device) -> List[Dict]:
    """`count` distinct batches of uint8 NHWC images and int32 labels, as the
    program's data pipeline hands them to a train step."""
    gen = generator(seed, TRAIN_DATA, device)
    size = cfg['image_size']
    images = torch.randint(0, 256, (count, batch, size, size, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    labels = torch.randint(0, cfg['nb_classes'], (count, batch), generator=gen,
                           device=device, dtype=torch.int32)
    return [{'image': images[i], 'label': labels[i]} for i in range(count)]


def normal_images(cfg: Dict, batch: int, count: int, seed: int, stream: int, device,
                  dtype=torch.float32) -> List[torch.Tensor]:
    """`count` distinct batches of standard normal NHWC images in `dtype`
    (normalized pixels, as a serving front end hands them over)."""
    size = cfg['image_size']
    draw = torch.randn((count, batch, size, size, 3), generator=generator(seed, stream, device),
                       device=device)
    return [draw[i].to(dtype) for i in range(count)]


def flip_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s augmentation generator."""
    return (int(seed) * 1000003 + FLIPS * 7919 + step) % (2 ** 62)
