"""Quantization policy + quant-site discovery for the uniform-quant learner
(counterpart of pocketflow_tpu/learners/uniform_quantization/utils.py).

Every PFConv/PFDense kernel passes through ``QuantPolicy.process_weight`` and
every relu output through ``process_act``.  Per-layer bit-widths are device
tensors in ``TrainState.extra``: a new bit list is a new tensor, and a step
never reads bits back to the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.nn.layers import CompressionPolicy, compression
from pocketflow_tpu_torch.ops import fake_quant as fq

FLAGS.DEFINE_integer('uql_weight_bits', 4, 'UQL: # of bits for weight quantization')
FLAGS.DEFINE_integer('uql_activation_bits', 32, 'UQL: # of bits for activation quantization')
FLAGS.DEFINE_boolean('uql_use_buckets', False, 'UQL: use bucketing or not')
FLAGS.DEFINE_integer('uql_bucket_size', 256, 'UQL: bucket size')
FLAGS.DEFINE_integer('uql_quant_epochs', 60, 'UQL: # of finetune epochs')
FLAGS.DEFINE_string('uql_save_quant_model_path',
                    './uql_quant_models/uql_quant_model.ckpt',
                    'UQL: quantized model save path')
FLAGS.DEFINE_boolean('uql_quantize_all_layers', False,
                     'UQL: if False, leave first and last layers unquantized')
FLAGS.DEFINE_string('uql_bucket_type', 'channel', "UQL: bucket type ('channel' | 'split')")


class _SiteRecorder(CompressionPolicy):
    """Records weight paths (call order) and counts activation sites."""

    def __init__(self):
        self.weight_paths: List[str] = []
        self.weight_shapes: List[Tuple[int, ...]] = []
        self.nb_acts = 0

    def reset_trace(self):
        super().reset_trace()
        self.weight_paths, self.weight_shapes, self.nb_acts = [], [], 0

    def process_weight(self, path, kernel):
        self.weight_paths.append(path)
        self.weight_shapes.append(tuple(kernel.shape))
        return kernel

    def process_act(self, path, act):
        if path.startswith('act/'):
            self.nb_acts += 1
        return act


@torch.no_grad()
def discover_quant_sites(model: torch.nn.Module, sample_images: torch.Tensor) -> Dict[str, Any]:
    """One eval-mode pass over `sample_images` to find conv/dense weights in
    call order and count activation sites; the first and last weights stay
    full precision unless --uql_quantize_all_layers."""
    recorder = _SiteRecorder()
    was_training = model.training
    model.eval()
    with compression(recorder):
        model(sample_images)
    model.train(was_training)
    paths = list(recorder.weight_paths)
    shapes = list(recorder.weight_shapes)
    if not FLAGS.uql_quantize_all_layers and len(paths) > 2:
        paths, shapes = paths[1:-1], shapes[1:-1]
    return {
        'weight_paths': paths,
        'weight_shapes': shapes,
        'num_weights': [int(np.prod(s)) for s in shapes],
        'nb_matmuls': len(paths),
        'nb_activations': recorder.nb_acts,
    }


class QuantPolicy(CompressionPolicy):
    """Fake-quantizes selected kernels + activations at per-layer bit-widths.

    ``quant_acts`` disables activation quantization when every activation
    runs at >= 32 bits, so that no relu pays for a quantization whose result
    the `where` discards.
    """

    def __init__(self, weight_paths: List[str], w_bits: torch.Tensor, a_bits: torch.Tensor,
                 quant_acts: bool = None):
        self.w_index = {p: i for i, p in enumerate(weight_paths)}
        self.w_bits = w_bits
        self.a_bits = a_bits
        self.quant_acts = (FLAGS.uql_activation_bits < 32
                           if quant_acts is None else quant_acts)

    def process_weight(self, path, kernel):
        idx = self.w_index.get(path)
        if idx is None:
            return kernel
        bits = self.w_bits[idx]
        if FLAGS.uql_use_buckets:
            if FLAGS.uql_bucket_type == 'channel':
                q = fq.fake_quant_channel_bucket(kernel, bits)
            elif FLAGS.uql_bucket_type == 'split':
                q = fq.fake_quant_split_bucket(kernel, bits, FLAGS.uql_bucket_size)
            else:
                raise ValueError('unrecognized bucket type: ' + FLAGS.uql_bucket_type)
        else:
            q = fq.fake_quant(kernel, bits)
        # bits >= 32 means full precision
        return torch.where(bits < 32, q, kernel)

    def process_act(self, path, act):
        if not path.startswith('act/') or not self.quant_acts:
            return act
        if self.a_bits.shape[0] == 0:
            return act
        idx = int(path.split('/')[1])  # call-order site id assigned by relu()
        bits = self.a_bits[idx]
        return torch.where(bits < 32, fq.fake_quant(act, bits).to(act.dtype), act)


def bits_state(statistics: Dict[str, Any], w_bit_list=None, a_bit_list=None,
               device='cpu') -> Dict[str, torch.Tensor]:
    """The `extra` tensors holding the per-layer bit lists."""
    w = w_bit_list if w_bit_list is not None \
        else [FLAGS.uql_weight_bits] * statistics['nb_matmuls']
    a = a_bit_list if a_bit_list is not None \
        else [FLAGS.uql_activation_bits] * statistics['nb_activations']
    return {'w_bits': torch.tensor(np.asarray(w, np.float32), device=device),
            'a_bits': torch.tensor(np.asarray(a, np.float32).reshape(-1), device=device)}


def bucket_storage_bits(statistics: Dict[str, Any]) -> int:
    """Total scale-factor overhead in bits."""
    if not FLAGS.uql_use_buckets:
        return 0
    total = 0
    for shape in statistics['weight_shapes']:
        total += fq.bucket_storage_bits(shape, FLAGS.uql_bucket_type, FLAGS.uql_bucket_size)
    return total
