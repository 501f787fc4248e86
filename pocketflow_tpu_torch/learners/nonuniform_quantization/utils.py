"""Codebook-quantization policy of the non-uniform quant learner
(counterpart of pocketflow_tpu/learners/nonuniform_quantization/utils.py).

Weights snap to per-layer learned codebooks (``ops/nonuniform_quant.py``,
plain PyTorch: exact codebook gradients and the STE); each activation goes
through K1' with the select on bits < 32 inside (``fake_quant_select``), where
the reference takes ``where(bits < 32, fake_quant(act, bits), act)``.
Codebooks are leaf tensors in ``TrainState.extra['codebooks']``, keyed by
layer path; they are not parameters of the model.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.learners.uniform_quantization import utils as uq_utils
from pocketflow_tpu_torch.nn.layers import CompressionPolicy
from pocketflow_tpu_torch.ops import fake_quant as fq
from pocketflow_tpu_torch.ops import nonuniform_quant as nuq

FLAGS.DEFINE_string('nuql_init_style', 'kmeans',
                    "NUQL: codebook init ('kmeans' = Lloyd refinement from the uniform "
                    "levels, the default | 'quantile' (reference parity) | 'uniform')")
FLAGS.DEFINE_string('nuql_opt_mode', 'weights',
                    "NUQL: trainable set ('weights' | 'cluster' | 'both')")
FLAGS.DEFINE_integer('nuql_weight_bits', 4, 'NUQL: weight quantization bits')
FLAGS.DEFINE_integer('nuql_activation_bits', 32, 'NUQL: activation quantization bits')
FLAGS.DEFINE_boolean('nuql_use_buckets', False, 'NUQL: use bucketing or not')
FLAGS.DEFINE_integer('nuql_bucket_size', 256, 'NUQL: bucket size')
FLAGS.DEFINE_integer('nuql_quant_epochs', 60, 'NUQL: # of finetune epochs')
FLAGS.DEFINE_string('nuql_save_quant_model_path',
                    './nuql_quant_models/model.ckpt', 'NUQL: quantized model save path')
FLAGS.DEFINE_boolean('nuql_quantize_all_layers', False,
                     'NUQL: if False, leave first and last layers unquantized')
FLAGS.DEFINE_string('nuql_bucket_type', 'split', "NUQL: bucket type ('split' | 'channel')")
# the RL bit search's knobs (BitOptimizer(prefix='nuql') reads them)
FLAGS.DEFINE_integer('nuql_equivalent_bits', 4, 'NUQL: bit budget equivalent bits')
FLAGS.DEFINE_integer('nuql_nb_rlouts', 200, 'NUQL: # of RL roll-outs')
FLAGS.DEFINE_integer('nuql_w_bit_min', 2, 'NUQL: minimum weight bits')
FLAGS.DEFINE_integer('nuql_w_bit_max', 8, 'NUQL: maximum weight bits')
FLAGS.DEFINE_integer('nuql_tune_layerwise_steps', 100, 'NUQL: layerwise finetune steps')
FLAGS.DEFINE_integer('nuql_tune_global_steps', 2101, 'NUQL: global finetune steps')
FLAGS.DEFINE_string('nuql_tune_save_path', './rl_tune_models/model.ckpt',
                    'NUQL: RL finetune save path')
FLAGS.DEFINE_integer('nuql_tune_disp_steps', 300, 'NUQL: finetune display interval')
FLAGS.DEFINE_boolean('nuql_enbl_random_layers', True, 'NUQL: shuffle layer order per roll-out')
FLAGS.DEFINE_boolean('nuql_enbl_rl_agent', False, 'NUQL: enable RL bit search')
FLAGS.DEFINE_boolean('nuql_enbl_rl_global_tune', True, 'NUQL: global finetune in roll-outs')
FLAGS.DEFINE_boolean('nuql_enbl_rl_layerwise_tune', False,
                     'NUQL: layerwise finetune in roll-outs')


def bucket_spec():
    bucket_type = FLAGS.nuql_bucket_type if FLAGS.nuql_use_buckets else None
    return bucket_type, FLAGS.nuql_bucket_size


class NonUniformQuantPolicy(CompressionPolicy):
    """Snaps the kernels that have a codebook to it; quantizes activations
    at their bits (a [nb_activations] tensor), bits >= 32 passing them
    through.  ``quant_acts`` False (no activation below 32 bits) spares each
    activation its pass; the caller reads it off the bits once per bit list."""

    def __init__(self, codebooks: Dict[str, torch.Tensor], a_bits: torch.Tensor,
                 quant_acts: bool = True):
        self.codebooks = codebooks
        self.a_bits = a_bits
        self.quant_acts = quant_acts

    def process_weight(self, path, kernel):
        c = self.codebooks.get(path)
        if c is None:
            return kernel
        return nuq.nonuniform_quant(kernel, c, *bucket_spec())

    def process_act(self, path, act):
        if not path.startswith('act/') or not self.quant_acts or self.a_bits.shape[0] == 0:
            return act
        return fq.fake_quant_act_select(act, self.a_bits[int(path.split('/')[1])])


@torch.no_grad()
def init_codebooks(model: torch.nn.Module, weight_paths: List[str],
                   w_bit_list) -> Dict[str, torch.Tensor]:
    """Per-layer codebooks from `model`'s current weights (built after a
    baseline restore), each a leaf [k, nb_buckets] tensor that requires grad."""
    bucket_type, bucket_size = bucket_spec()
    weights = uq_utils.quant_weights(model, weight_paths)
    return {path: nuq.init_codebook(w, int(bits), FLAGS.nuql_init_style, bucket_type,
                                    bucket_size).requires_grad_(True)
            for path, w, bits in zip(weight_paths, weights, w_bit_list)}
