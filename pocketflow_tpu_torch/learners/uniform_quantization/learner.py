"""Uniform-quantization (QAT) learner
(counterpart of pocketflow_tpu/learners/uniform_quantization/learner.py).

Flow: restore the pretrained full-precision baseline -> pick per-layer weight
bits (uniform lists; the DDPG search waits) -> finetune ``uql_quant_epochs``
with the quantized forward -> evaluate.  The quantization is a `QuantPolicy`
applied inside the train step, with per-layer bits as device tensors in
``TrainState.extra``; the fake-quant forward runs in the CUDA kernels of
ops/fake_quant.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import schedules
from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner, Sgd, TrainState
from pocketflow_tpu_torch.learners.uniform_quantization import utils as uq_utils

FLAGS.DEFINE_boolean('uql_enbl_rl_agent', False, 'UQL: enable RL bit search')


def setup_bnds_decay_rates(model_name: str, dataset_name: str):
    """LR bounds/decays for the quant finetune."""
    if dataset_name in ('cifar_10', 'cifar10'):
        bnd_epochs, decay_rates = [15, 40], [1e-3, 1e-4, 1e-5]
    elif dataset_name in ('ilsvrc_12', 'ilsvrc12'):
        if model_name.startswith('mobilenet'):
            bnd_epochs, decay_rates = [5, 30], [1e-4, 1e-5, 1e-6]
        else:
            bnd_epochs, decay_rates = [5, 20], [1e-4, 1e-5, 1e-6]
    else:
        bnd_epochs, decay_rates = [15, 40], [1e-3, 1e-4, 1e-5]
    return bnd_epochs, decay_rates


def quant_finetune_schedule(model_name: str, dataset_name: str,
                            nb_smpls: int, global_batch_size: int,
                            quant_epochs: float = None):
    """Quant-finetune LR schedule + step count."""
    bnd_epochs, decay_rates = setup_bnds_decay_rates(model_name, dataset_name)
    schedule = schedules.piecewise_constant(
        global_batch_size, bnd_epochs, decay_rates, nb_smpls)
    epochs = quant_epochs if quant_epochs is not None else FLAGS.uql_quant_epochs
    finetune_steps = max(1, int(
        nb_smpls * epochs * FLAGS.nb_epochs_rat / global_batch_size))
    return schedule, finetune_steps


class UniformQuantLearner(AbstractLearner):
    """Uniform quantization of weights (and optionally activations)."""

    def __init__(self, sm_writer, model_helper, device='cuda'):
        super().__init__(sm_writer, model_helper, device)
        if FLAGS.enbl_dst:
            raise NotImplementedError(
                "--enbl_dst is not ported yet (ROADMAP 'Modules to port', item 13)")
        # discover quant sites with one eval-mode pass over two synthetic
        # images (only the shapes matter)
        sample = torch.from_numpy(self.dataset_train.synthesize_arrays(2)[0][:2])
        sample = self.dataset_train.augment(sample.to(self.device), None, False)
        self.statistics = uq_utils.discover_quant_sites(self.create_model(), sample)

        self.optimal_w_bit_list: Optional[List[int]] = None
        self.optimal_a_bit_list: Optional[List[int]] = None

    # ------------------------------------------------------------------
    # state and steps
    # ------------------------------------------------------------------

    def _policy_fn(self):
        weight_paths = self.statistics['weight_paths']

        def policy_fn(state: TrainState):
            return uq_utils.QuantPolicy(
                weight_paths, state.extra['w_bits'], state.extra['a_bits'])

        return policy_fn

    def quant_schedule(self) -> Tuple[schedules.Schedule, int]:
        return quant_finetune_schedule(
            self.model_name, self.dataset_name,
            self.dataset_train.spec.nb_smpls_train, self.global_batch_size)

    def init_state_quant(self, w_bit_list=None, a_bit_list=None):
        """Init state whose extra carries the per-layer bit tensors; the
        optimizer follows the quant-finetune schedule."""
        extra = uq_utils.bits_state(self.statistics, w_bit_list, a_bit_list, self.device)
        state, _, _ = self.init_state(extra=extra)
        schedule, self.finetune_steps = self.quant_schedule()
        tx = Sgd(schedule, FLAGS.momentum)
        state.optimizer = tx.init(state.model)
        return state, tx, schedule

    def build_quant_train_step(self, tx):
        return self.build_train_step(tx, policy_fn=self._policy_fn())

    def build_quant_eval_step(self):
        return self.build_eval_step(policy_fn=self._policy_fn())

    def set_bits(self, state: TrainState, w_bit_list, a_bit_list) -> TrainState:
        extra = uq_utils.bits_state(self.statistics, w_bit_list, a_bit_list, self.device)
        return self.set_extra(state, extra)

    def choose_bits(self) -> Tuple[List[int], List[int]]:
        """BitOptimizer.run: uniform bit lists from the flags.  The DDPG
        search under a bit budget is not ported yet."""
        if FLAGS.uql_enbl_rl_agent:
            raise NotImplementedError(
                "--uql_enbl_rl_agent is not ported yet (ROADMAP 'Modules to port', item 16)")
        return ([FLAGS.uql_weight_bits] * self.statistics['nb_matmuls'],
                [FLAGS.uql_activation_bits] * self.statistics['nb_activations'])

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def train(self) -> TrainState:
        state, tx, _ = self.init_state_quant()
        state, _ = self.restore_baseline(state)  # pretrained baseline
        self.optimal_w_bit_list, self.optimal_a_bit_list = self.choose_bits()
        state = self.set_bits(state, self.optimal_w_bit_list, self.optimal_a_bit_list)
        self.log.info('optimal weight bits: %s', self.optimal_w_bit_list)

        train_step = self.build_quant_train_step(tx)
        eval_step = self.build_quant_eval_step()
        state = self.run_train_loop(
            state, train_step, nb_iters=self.finetune_steps,
            save_path=FLAGS.uql_save_quant_model_path,
            eval_fn=lambda s: self.run_eval_loop(s, eval_step))
        self.run_eval_loop(state, eval_step)
        if FLAGS.uql_use_buckets:
            self.log.info('bucket storage overhead: %d bits',
                          uq_utils.bucket_storage_bits(self.statistics))
        return state

    def evaluate(self) -> Dict[str, float]:
        state, _, _ = self.init_state_quant(
            self.optimal_w_bit_list, self.optimal_a_bit_list)
        restored = self.restore_model(state, FLAGS.uql_save_quant_model_path)
        if restored is None:
            raise FileNotFoundError(
                'no checkpoint found under ' + FLAGS.uql_save_quant_model_path)
        return self.run_eval_loop(restored, self.build_quant_eval_step())
