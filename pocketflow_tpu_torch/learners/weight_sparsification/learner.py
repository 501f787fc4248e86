"""Weight-sparsification learner: magnitude pruning on a dynamic schedule
(counterpart of pocketflow_tpu/learners/weight_sparsification/learner.py).

The masks and the fp32 weight backups live in ``TrainState.extra``.  Per-layer
final ratios come from the PROptimizer ('uniform' | 'heurist' | 'optimal'
DDPG search); the ratio of a refresh follows the Zhu & Gupta schedule between
``ws_iter_ratio_beg`` and ``ws_iter_ratio_end``.  The train step
(``build_sparse_train_step``) keeps pruned weights exactly zero.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner, TrainState
from pocketflow_tpu_torch.learners.distillation_helper import DistillationHelper
from pocketflow_tpu_torch.learners.weight_sparsification import masking
from pocketflow_tpu_torch.learners.weight_sparsification.pr_optimizer import PROptimizer


class WeightSparseLearner(AbstractLearner):
    """Weight sparsification learner."""

    def __init__(self, sm_writer, model_helper, device='cuda'):
        super().__init__(sm_writer, model_helper, device)
        self.helper_dst = None
        if FLAGS.enbl_dst:
            self.helper_dst = DistillationHelper(model_helper, self.device)
        self.var_names_n_prune_ratios: Optional[List[Tuple[str, float]]] = None

    # ------------------------------------------------------------------

    def train(self) -> TrainState:
        if FLAGS.ws_prune_ratio_prtl == 'optimal' and self.var_names_n_prune_ratios is None:
            self.require_dp_only('the optimal-protocol RL search')
        state, tx, _ = self.init_state()
        state, _ = self.restore_baseline(state)  # the pretrained full-precision baseline

        if self.var_names_n_prune_ratios is None:
            self.var_names_n_prune_ratios = PROptimizer(self).run(state.model)
        state, train_step = self.build_sparse_train_step(
            tx, state, dict(self.var_names_n_prune_ratios))
        eval_step = self.build_sparse_eval_step()
        state = self.run_train_loop(state, train_step, save_path=FLAGS.ws_save_path,
                                    eval_fn=lambda s: self.run_eval_loop(s, eval_step))
        self.run_eval_loop(state, eval_step)
        return state

    def evaluate(self) -> Dict[str, float]:
        state, _, _ = self.init_state()
        params = dict(state.model.named_parameters())
        state = self.set_extra(state, masking.build_mask_state(params))
        restored = self.restore_model(state, FLAGS.ws_save_path)
        if restored is None:
            raise FileNotFoundError('no checkpoint found under ' + FLAGS.ws_save_path)
        return self.run_eval_loop(restored, self.build_sparse_eval_step())

    # ------------------------------------------------------------------

    def build_sparse_train_step(self, tx, state: TrainState, ratios_fnl: Dict[str, float]):
        """Attach all-ones masks and weight backups to `state` and build its
        train step: the maskable kernels' gradients masked, the masks
        refreshed at the dynamic ratio every ws_mask_update_step steps while
        the schedule is live (the step count is the host's, so the test
        costs no wait), and re-applied after every update.  The step updates
        the model's parameters in place, so they are looked up once, here.
        Returns (state, train_step)."""
        params = dict(state.model.named_parameters())
        state = self.set_extra(state, masking.build_mask_state(params))
        maskable = {name: params[name] for name in masking.maskable_paths(params)}
        nb_iters = self.nb_iters_train
        upd_step = max(1, int(FLAGS.ws_mask_update_step))
        idx_beg = int(nb_iters * FLAGS.ws_iter_ratio_beg)
        idx_end = int(nb_iters * FLAGS.ws_iter_ratio_end)

        def grad_transform(s: TrainState):
            masking.mask_gradients_({n: p.grad for n, p in maskable.items()}, s.extra['masks'])

        def post_update(s: TrainState) -> TrainState:
            step = s.step  # counted after the update
            # refresh every upd_step steps while the schedule is live (before
            # idx_beg the ratio is 0, and a refresh would still zero the
            # smallest ties), and once more just after idx_end
            if step % upd_step == 0 and idx_beg <= step <= idx_end + upd_step:
                with torch.no_grad():
                    new_params, s.extra = masking.prune_update(params, s.extra, step, nb_iters,
                                                               ratios_fnl)
                    for name, p in maskable.items():
                        p.copy_(new_params[name])
            # keep pruned weights exactly zero between refreshes: the
            # momentum trace predates the mask and would move them
            masking.apply_masks_(maskable, s.extra['masks'])
            return s

        loss_extra = self.helper_dst.loss_extra_fn() if self.helper_dst else None
        return state, self.build_train_step(tx, loss_extra_fn=loss_extra,
                                            grad_transform_fn=grad_transform,
                                            post_update_fn=post_update)

    def build_sparse_eval_step(self):
        """The eval step, which also reports the overall pruning ratio of all
        parameters (pr_trn) and of the maskable ones (pr_msk)."""
        eval_step = self.build_eval_step()

        @torch.no_grad()
        def step_fn(state: TrainState, batch):
            params = dict(state.model.named_parameters())
            return {**eval_step(state, batch),
                    'pr_trn': masking.calc_prune_ratio(params),
                    'pr_msk': masking.calc_prune_ratio(params, maskable_only=True)}

        return step_fn
