"""Deployment-grade QAT learner ('uniform-tf'): 8/8 bits, moving-average
activation ranges, quant delay, BN-freeze delay (counterpart of
pocketflow_tpu/learners/uniform_quantization_tf/learner.py).

The quantization is a policy in the forward:

* weights: per-output-channel min/max fake-quant at ``uqtf_weight_bits``,
  every weight of the model (first and last included) in one grouped K2'
  launch pair a forward (``fake_quant_bucket_group`` without the select);
  under tensor parallelism a sharded kernel's channels are its own columns,
  so its shard is quantized as it is;
* activations: fake-quant against an exponential-moving-average (min, max)
  range per activation site (``fake_quant_with_range``, plain PyTorch as in
  the reference), the ranges in ``TrainState.extra``; each site records its
  batch's fp32 min and max, and after the backward the ranges move on the
  device to ``ema * old + (1 - ema) * batch``, whether or not quantization is
  on yet;
* ``uqtf_quant_delay``: the step count is on the host, so before the delay a
  step launches no fake-quant and the forward sees the weights and
  activations as they are (the reference's ``where(enabled, q, x)``, whose
  gradient is the identity either way);
* ``uqtf_freeze_bn_delay``: from that step on the step runs the eval-mode
  forward with gradients: BN normalizes with its running statistics and
  leaves them unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.core.profiling import span
from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner, Sgd, TrainState
from pocketflow_tpu_torch.learners.distillation_helper import DistillationHelper
from pocketflow_tpu_torch.learners.uniform_quantization import utils as uq_utils
from pocketflow_tpu_torch.learners.uniform_quantization.learner import quant_finetune_schedule
from pocketflow_tpu_torch.nn.layers import CompressionPolicy, recomputing
from pocketflow_tpu_torch.ops import fake_quant as fq

FLAGS.DEFINE_string('uqtf_save_path', './models_uqtf/model.ckpt',
                    "UQ-TF: model's save path")
FLAGS.DEFINE_string('uqtf_save_path_eval', './models_uqtf_eval/model.ckpt',
                    "UQ-TF: model's save path for evaluation")
FLAGS.DEFINE_integer('uqtf_weight_bits', 8, 'UQ-TF: # of bits for weight quantization')
FLAGS.DEFINE_integer('uqtf_activation_bits', 8,
                     'UQ-TF: # of bits for activation quantization')
FLAGS.DEFINE_integer('uqtf_quant_delay', 0,
                     'UQ-TF: # of steps after which quantization starts')
FLAGS.DEFINE_integer('uqtf_freeze_bn_delay', None,
                     'UQ-TF: # of steps after which BN statistics freeze')
FLAGS.DEFINE_float('uqtf_lrn_rate_dcy', 1.0,
                   'UQ-TF: finetune learning-rate scale factor (1.0 keeps the quant '
                   'finetune schedule, other values rescale it)')
FLAGS.DEFINE_boolean('uqtf_enbl_manual_quant', False,
                     'UQ-TF: manually insert activation quant sites '
                     '(always on here: the policy reaches every relu)')
FLAGS.DEFINE_float('uqtf_ema_decay', 0.999, 'UQ-TF: activation-range EMA decay')


class RangeQuantPolicy(CompressionPolicy):
    """Quantizes the weights per output channel and the activations against
    the EMA ranges; with `record`, keeps each activation site's batch (min,
    max) for the EMA update.

    `weights` are the kernels at `weight_paths` (``uq_utils.quant_weights``):
    the first ``process_weight`` of a forward quantizes them all in one
    grouped call at `w_bits` (a [T] tensor) and each site takes its result.
    `enabled` False (before the quant delay) leaves weights and activations
    as they are."""

    def __init__(self, weight_paths: List[str], weights: List[torch.Tensor],
                 w_bits: torch.Tensor, act_min: torch.Tensor, act_max: torch.Tensor,
                 a_bits: torch.Tensor, enabled: bool, record: bool):
        if len(weights) != len(weight_paths):
            raise ValueError('%d weights for %d weight paths' % (len(weights), len(weight_paths)))
        self.w_index = {p: i for i, p in enumerate(weight_paths)}
        self.weights = weights
        self.w_bits = w_bits
        self.act_min, self.act_max, self.a_bits = act_min, act_max, a_bits
        self.enabled = enabled
        self.record = record
        self._grouped = None
        self.batch_ranges: List[Tuple[int, torch.Tensor]] = []

    def reset_trace(self):
        super().reset_trace()
        self._grouped = None
        self.batch_ranges = []

    def process_weight(self, path, kernel):
        idx = self.w_index.get(path)
        if idx is None or not self.enabled:
            return kernel
        if kernel is not self.weights[idx]:
            raise ValueError('RangeQuantPolicy: the kernel at %s is not the weight the policy '
                             'was built with' % path)
        self.prepare()  # at the forward's first site
        return self._grouped[idx]

    def prepare(self):
        """All the weights in one grouped call, once a quantized forward."""
        if self._grouped is not None or not self.enabled or not self.weights:
            return
        if recomputing():
            raise RuntimeError('RangeQuantPolicy: a block recompute found no grouped weights')
        # channel buckets take no bucket size
        self._grouped = fq.fake_quant_bucket_group(self.weights, self.w_bits, 'channel', 0,
                                                   select=False)

    def process_act(self, path, act):
        if not path.startswith('act/') or self.act_min.shape[0] == 0:
            return act
        idx = int(path.split('/')[1])
        with span('quant.act'):
            if self.record and not recomputing():  # a recompute records nothing
                self.batch_ranges.append((idx, torch.stack(torch.aminmax(act.detach()))))
            if not self.enabled:
                return act
            return fq.fake_quant_with_range(act, self.act_min[idx], self.act_max[idx],
                                            self.a_bits)

    def update_ranges(self, ema: float):
        """act_min, act_max <- ema * old + (1 - ema) * this forward's batch
        (min, max), in place on the device, every site at once (the global
        batch's under data parallelism: one all-reduce for all sites)."""
        idxs = [idx for idx, _ in self.batch_ranges]
        if idxs != list(range(self.act_min.shape[0])):
            raise RuntimeError('the forward recorded activation sites %s, not each of the %d '
                               'once in order' % (idxs, self.act_min.shape[0]))
        batch = torch.stack([r for _, r in self.batch_ranges]).to(torch.float32)
        # under data parallelism, each site's range over the global batch
        mesh.all_reduce_minmax_(batch)
        with torch.no_grad():
            for i, ranges in enumerate((self.act_min, self.act_max)):
                ranges.copy_(ema * ranges + (1 - ema) * batch[:, i])


class UniformQuantTFLearner(AbstractLearner):
    """8/8 QAT with EMA activation ranges and quant/BN-freeze delays."""

    def __init__(self, sm_writer, model_helper, device='cuda'):
        super().__init__(sm_writer, model_helper, device)
        self.helper_dst = None
        if FLAGS.enbl_dst:
            self.helper_dst = DistillationHelper(model_helper, self.device)
        sample = torch.from_numpy(self.dataset_train.synthesize_arrays(2)[0][:2])
        sample = self.dataset_train.augment(sample.to(self.device), None, False)
        with FLAGS.scope(uql_quantize_all_layers=True):  # TF rewrites all layers
            self.statistics = uq_utils.discover_quant_sites(self.create_model(shard=False), sample)
        self.w_bits = torch.full((self.statistics['nb_matmuls'],), float(FLAGS.uqtf_weight_bits),
                                 device=self.device)
        self.a_bits = torch.tensor(float(FLAGS.uqtf_activation_bits), device=self.device)

    # ------------------------------------------------------------------

    def _policy_fn(self):
        """policy_fn(state, enabled, record) -> RangeQuantPolicy, the model's
        weights looked up once per model."""
        weight_paths = self.statistics['weight_paths']
        found = {}

        def policy_fn(state: TrainState, enabled: bool, record: bool):
            if found.get('model') is not state.model:
                found.update(model=state.model,
                             weights=uq_utils.quant_weights(state.model, weight_paths))
            return RangeQuantPolicy(weight_paths, found['weights'], self.w_bits,
                                    state.extra['act_min'], state.extra['act_max'], self.a_bits,
                                    enabled, record)

        return policy_fn

    def init_state_quant(self):
        nb_acts = self.statistics['nb_activations']
        extra = {'act_min': torch.zeros(nb_acts, device=self.device),
                 'act_max': torch.full((nb_acts,), 6.0, device=self.device)}
        state, _, _ = self.init_state(extra=extra)
        base, self.finetune_steps = quant_finetune_schedule(
            self.model_name, self.dataset_name, self.dataset_train.spec.nb_smpls_train,
            self.global_batch_size)
        # a factor other than 1.0 rescales the whole finetune schedule, in
        # fp32 as the JAX package's schedule values are
        dcy = float(FLAGS.uqtf_lrn_rate_dcy)
        schedule = base if dcy == 1.0 else (
            lambda step: float(np.float32(base(step)) * np.float32(dcy)))
        tx = Sgd(schedule, FLAGS.momentum)
        state.optimizer = tx.init(state.model)
        return state, tx, schedule

    def build_qat_train_step(self, tx: Sgd, freeze_bn: bool):
        """The train step: the forward quantizes against the ranges before
        the step (from step uqtf_quant_delay on), then the backward and the
        update, then the EMA of the ranges; with `freeze_bn`, the eval-mode
        forward (running statistics used and left unchanged)."""
        policy_fn = self._policy_fn()
        ema = FLAGS.uqtf_ema_decay
        quant_delay = FLAGS.uqtf_quant_delay
        made = {}

        def train_policy(state):
            made['policy'] = policy_fn(state, enabled=state.step >= quant_delay, record=True)
            return made['policy']

        def update_ranges(state):
            made.pop('policy').update_ranges(ema)
            return state

        return self.build_train_step(
            tx, policy_fn=train_policy,
            loss_extra_fn=self.helper_dst.loss_extra_fn() if self.helper_dst else None,
            post_update_fn=update_ranges, frozen_bn=freeze_bn)

    def build_qat_eval_step(self):
        """The eval step: always quantized, recording nothing."""
        policy_fn = self._policy_fn()
        return self.build_eval_step(
            policy_fn=lambda state: policy_fn(state, enabled=True, record=False))

    # ------------------------------------------------------------------

    def train(self) -> TrainState:
        state, tx, _ = self.init_state_quant()
        # resume from this learner's own checkpoints first: a preempted run
        # must not retrain from the full-precision baseline
        resumed = self.restore_model(state, FLAGS.uqtf_save_path)
        if resumed is not None:
            state = resumed
        else:
            state, _ = self.restore_baseline(state)
        step_bn = self.build_qat_train_step(tx, freeze_bn=False)
        step_frozen = self.build_qat_train_step(tx, freeze_bn=True)
        freeze_at = FLAGS.uqtf_freeze_bn_delay

        def train_step(state, batch, generator):
            frozen = freeze_at is not None and state.step >= freeze_at
            return (step_frozen if frozen else step_bn)(state, batch, generator)

        state = self.run_train_loop(state, train_step, nb_iters=self.finetune_steps,
                                    save_path=FLAGS.uqtf_save_path)
        self.run_eval_loop(state, self.build_qat_eval_step())
        return state

    def evaluate(self) -> Dict[str, float]:
        state, _, _ = self.init_state_quant()
        restored = self.restore_model(state, FLAGS.uqtf_save_path)
        if restored is None:
            raise FileNotFoundError('no checkpoint found under ' + FLAGS.uqtf_save_path)
        return self.run_eval_loop(restored, self.build_qat_eval_step())

    def export_quant_spec(self, state: TrainState) -> Dict:
        """The trained quantization spec a deployment export embeds: the EMA
        activation ranges and the weight sites and bits."""
        return {'weight_paths': list(self.statistics['weight_paths']),
                'act_min': state.extra['act_min'].cpu().numpy().astype(np.float32),
                'act_max': state.extra['act_max'].cpu().numpy().astype(np.float32),
                'weight_bits': int(FLAGS.uqtf_weight_bits),
                'act_bits': int(FLAGS.uqtf_activation_bits)}
