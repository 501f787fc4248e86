"""Non-uniform quantization learner, learned codebooks (counterpart of
pocketflow_tpu/learners/nonuniform_quantization/learner.py).

Weights snap to per-layer codebooks while training; ``--nuql_opt_mode``
chooses what trains: 'weights' (codebooks frozen), 'cluster' (weights
frozen) or 'both'.  One SGD with momentum covers the model's parameters and,
in a second group, the codebooks; the mode zeroes one side's gradients.
Codebooks are built from the restored weights, live in
``TrainState.extra['codebooks']`` and stay out of the weight decay.  A new
bit list rebuilds them and the optimizer (their shapes depend on k = 2^bits).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner, Sgd, TrainState
from pocketflow_tpu_torch.learners.distillation_helper import DistillationHelper
from pocketflow_tpu_torch.learners.nonuniform_quantization import utils as nuq_utils
from pocketflow_tpu_torch.learners.uniform_quantization import utils as uq_utils
from pocketflow_tpu_torch.learners.uniform_quantization.bit_optimizer import BitOptimizer
from pocketflow_tpu_torch.learners.uniform_quantization.learner import quant_finetune_schedule

OPT_MODES = ('weights', 'cluster', 'both')


class NonUniformQuantLearner(AbstractLearner):
    """Non-uniform (codebook) quantization of weights."""

    def __init__(self, sm_writer, model_helper, device='cuda'):
        super().__init__(sm_writer, model_helper, device)
        self.helper_dst = None
        if FLAGS.enbl_dst:
            self.helper_dst = DistillationHelper(model_helper, self.device)
        sample = torch.from_numpy(self.dataset_train.synthesize_arrays(2)[0][:2])
        sample = self.dataset_train.augment(sample.to(self.device), None, False)
        with FLAGS.scope(uql_quantize_all_layers=FLAGS.nuql_quantize_all_layers):
            self.statistics = uq_utils.discover_quant_sites(self.create_model(), sample)
        self._tx: Optional[Sgd] = None
        self.optimal_w_bit_list: Optional[List[int]] = None
        self.optimal_a_bit_list: Optional[List[int]] = None

    # ------------------------------------------------------------------

    def _policy_fn(self):
        found = {}  # the activation bits last seen, and whether any is below 32

        def policy_fn(state: TrainState):
            a_bits = state.extra['a_bits']
            if found.get('a_bits') is not a_bits:  # once per bit list, not per step
                found.update(a_bits=a_bits, quant_acts=bool((a_bits < 32).any()))
            return nuq_utils.NonUniformQuantPolicy(state.extra['codebooks'], a_bits,
                                                   found['quant_acts'])
        return policy_fn

    def quant_schedule(self):
        return quant_finetune_schedule(
            self.model_name, self.dataset_name, self.dataset_train.spec.nb_smpls_train,
            self.global_batch_size, quant_epochs=FLAGS.nuql_quant_epochs)

    def _build_extra(self, model: torch.nn.Module, w_bits, a_bits) -> Dict:
        return {'codebooks': nuq_utils.init_codebooks(model, self.statistics['weight_paths'],
                                                      w_bits),
                'a_bits': torch.tensor(np.asarray(a_bits, np.float32).reshape(-1),
                                       device=self.device)}

    def init_state_quant(self, w_bit_list=None, a_bit_list=None):
        """A state whose extra holds codebooks at `w_bit_list` (default: the
        flags' uniform bits) and the activation bits; the optimizer follows
        the quant-finetune schedule over parameters and codebooks."""
        w_bits = w_bit_list if w_bit_list is not None else \
            [FLAGS.nuql_weight_bits] * self.statistics['nb_matmuls']
        a_bits = a_bit_list if a_bit_list is not None else \
            [FLAGS.nuql_activation_bits] * self.statistics['nb_activations']
        state, _, _ = self.init_state()
        schedule, self.finetune_steps = self.quant_schedule()
        self._tx = Sgd(schedule, FLAGS.momentum)
        return self.set_bits(state, w_bits, a_bits), self._tx, schedule

    def set_bits(self, state: TrainState, w_bit_list, a_bit_list) -> TrainState:
        """Codebooks re-derived from the current weights at new bit widths,
        and a new optimizer: the old codebooks' momentum cannot apply to
        codebooks of other shapes."""
        state = self.set_extra(state, self._build_extra(state.model, w_bit_list, a_bit_list))
        state.optimizer = self._tx.init(state.model, list(state.extra['codebooks'].values()))
        return state

    # ------------------------------------------------------------------

    def build_quant_train_step(self, tx: Sgd):
        """The train step: parameters and codebooks both take gradients
        (the weight decay covers the parameters only), and --nuql_opt_mode
        zeroes one side's before the update."""
        opt_mode = FLAGS.nuql_opt_mode
        if opt_mode not in OPT_MODES:
            raise ValueError('unrecognized opt mode: ' + opt_mode)

        def zero_frozen_grads(state: TrainState):
            frozen = {'weights': state.extra['codebooks'].values(),
                      'cluster': state.model.parameters(), 'both': ()}[opt_mode]
            for leaf in frozen:
                if leaf.grad is not None:
                    leaf.grad.zero_()

        return self.build_train_step(
            tx, policy_fn=self._policy_fn(),
            loss_extra_fn=self.helper_dst.loss_extra_fn() if self.helper_dst else None,
            grad_transform_fn=zero_frozen_grads)

    def build_quant_eval_step(self):
        return self.build_eval_step(policy_fn=self._policy_fn())

    # ------------------------------------------------------------------

    def train(self) -> TrainState:
        state, tx, _ = self.init_state_quant()
        state, restored = self.restore_baseline(state)
        if restored:  # codebooks come from the restored weights
            state = self.set_bits(
                state, [FLAGS.nuql_weight_bits] * self.statistics['nb_matmuls'],
                [FLAGS.nuql_activation_bits] * self.statistics['nb_activations'])
        self.optimal_w_bit_list, self.optimal_a_bit_list = BitOptimizer(
            self, state, prefix='nuql').run()
        state = self.set_bits(state, self.optimal_w_bit_list, self.optimal_a_bit_list)
        self.log.info('optimal weight bits: %s', self.optimal_w_bit_list)

        eval_step = self.build_quant_eval_step()
        state = self.run_train_loop(
            state, self.build_quant_train_step(tx), nb_iters=self.finetune_steps,
            save_path=FLAGS.nuql_save_quant_model_path,
            eval_fn=lambda s: self.run_eval_loop(s, eval_step))
        self.run_eval_loop(state, eval_step)
        return state

    def evaluate(self) -> Dict[str, float]:
        state, _, _ = self.init_state_quant(self.optimal_w_bit_list, self.optimal_a_bit_list)
        restored = self.restore_model(state, FLAGS.nuql_save_quant_model_path)
        if restored is None:
            raise FileNotFoundError(
                'no checkpoint found under ' + FLAGS.nuql_save_quant_model_path)
        return self.run_eval_loop(restored, self.build_quant_eval_step())
