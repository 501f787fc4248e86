"""Bit-width optimizer: per-layer weight bits by a DDPG search under a bit
budget (counterpart of pocketflow_tpu/learners/uniform_quantization/bit_optimizer.py).

A roll-out: the agent proposes every layer's weight bits (2-8, the budget
forcing the last layer to absorb what remains), a copy of the baseline state
(``learner.copy_state``) takes those bits, optionally regresses layer by layer
onto the baseline and finetunes, and its accuracy on a held-out split of the
train set is the reward; then the agent trains once per layer.  Each
roll-out's quantized forward sends all of its bit widths through one grouped
fake-quant launch pair.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.core.metrics import get_logger
from pocketflow_tpu_torch.learners.abstract_learner import Sgd
from pocketflow_tpu_torch.learners.capture import capture_forward
from pocketflow_tpu_torch.learners.uniform_quantization.rl_helper import RLHelper
from pocketflow_tpu_torch.rl_agents.ddpg.agent import DdpgAgent

FLAGS.DEFINE_integer('uql_equivalent_bits', 4,
                     'UQL: equivalent compression bits for the bit budget')
FLAGS.DEFINE_integer('uql_nb_rlouts', 200, 'UQL: # of RL roll-outs')
FLAGS.DEFINE_integer('uql_w_bit_min', 2, 'UQL: minimum weight bits')
FLAGS.DEFINE_integer('uql_w_bit_max', 8, 'UQL: maximum weight bits')
FLAGS.DEFINE_integer('uql_tune_layerwise_steps', 100, 'UQL: layerwise finetune steps')
FLAGS.DEFINE_integer('uql_tune_global_steps', 2000, 'UQL: global finetune steps')
FLAGS.DEFINE_string('uql_tune_save_path', './rl_tune_models/model.ckpt',
                    'UQL: RL finetune save path')
FLAGS.DEFINE_integer('uql_tune_disp_steps', 300, 'UQL: finetune display interval')
FLAGS.DEFINE_boolean('uql_enbl_random_layers', True, 'UQL: shuffle layer order per roll-out')
FLAGS.DEFINE_boolean('uql_enbl_rl_agent', False, 'UQL: enable RL bit search')
FLAGS.DEFINE_boolean('uql_enbl_rl_global_tune', True, 'UQL: global finetune in roll-outs')
FLAGS.DEFINE_boolean('uql_enbl_rl_layerwise_tune', False, 'UQL: layerwise finetune in roll-outs')


def tune_seed(rand_seed: int, idx_rlout: int, step: int) -> int:
    """The seed of a roll-out's global-tune step: the roll-out's seed
    (rand_seed + idx_rlout) folded with the step."""
    return int(np.random.SeedSequence([rand_seed + idx_rlout, step]).generate_state(1)[0])


class BitOptimizer:
    """Chooses the per-layer (weight, activation) bit lists of a quantization
    learner.  ``prefix`` names its flags (``<prefix>_<name>``) and its search
    checkpoint: 'uql' for the uniform learner, 'nuql' for the non-uniform
    one; the search is the same."""

    def __init__(self, learner, baseline_state, prefix: str = 'uql'):
        self.learner = learner
        self.baseline_state = baseline_state
        self.statistics = learner.statistics
        self.prefix = prefix
        self.log = get_logger()
        self.total_num_weights = sum(self.statistics['num_weights'])
        self.total_bits = self.total_num_weights * self._f('equivalent_bits')

    def _f(self, name: str):
        return getattr(FLAGS, '%s_%s' % (self.prefix, name))

    def run(self) -> Tuple[List[int], List[int]]:
        if not self._f('enbl_rl_agent'):
            return ([self._f('weight_bits')] * self.statistics['nb_matmuls'],
                    [self._f('activation_bits')] * self.statistics['nb_activations'])
        return self._calc_optimal_bits()

    # ------------------------------------------------------------------

    def _calc_optimal_bits(self) -> Tuple[List[int], List[int]]:
        learner = self.learner
        stats = self.statistics
        nb_layers = stats['nb_matmuls']
        fp_a_bits = [32] * stats['nb_activations']

        rl_helper = RLHelper(
            self.total_bits, stats['num_weights'], stats['weight_shapes'],
            random_layers=self._f('enbl_random_layers'), seed=FLAGS.rand_seed,
            bit_min=self._f('w_bit_min'), bit_max=self._f('w_bit_max'))
        agent = DdpgAgent(
            s_dims=rl_helper.s_dims, a_dims=1, nb_rlouts=self._f('nb_rlouts'),
            buf_size=nb_layers * max(1, self._f('nb_rlouts') // 4),
            a_min=0.0, a_max=self._f('w_bit_max') - self._f('w_bit_min'),
            seed=FLAGS.rand_seed, device=learner.device)
        agent.init()

        programs = self.rollout_programs()

        # resume a preempted search from its latest checkpoint
        search_path = os.path.join(os.path.dirname(self._f('tune_save_path')) or '.',
                                   'ddpg_search_%s.npz' % self.prefix)
        reward_opt, w_bits_opt, idx_beg = -np.inf, None, 0
        if agent.restore_search(search_path):
            extras = agent.restored_extras
            idx_beg = int(extras.get('idx_rlout', -1)) + 1
            reward_opt = float(extras.get('reward_best', -np.inf))
            arr_best = extras.get('w_bits_best')
            if arr_best is not None and np.size(arr_best) == nb_layers:
                w_bits_opt = [int(b) for b in arr_best]
            self.log.info('resumed bit search from %s at rlout #%d', search_path, idx_beg)

        for idx_rlout in range(idx_beg, self._f('nb_rlouts')):
            # 1. per-layer bits, the layers visited in a random order or not
            rl_helper.reset()
            agent.init_rlout()
            states, actions, layer_bits = [], [], np.zeros(nb_layers)
            for idx in rl_helper.layer_idxs:
                state_vec = rl_helper.calc_state(idx)
                action = agent.actions_noisy(state_vec)
                layer_bits[idx] = rl_helper.calc_w(action, idx)[0][0]
                states.append(state_vec[0])
                actions.append(action[0])
            w_bit_list = [int(b) for b in layer_bits]

            # 2. a copy of the baseline at these bits, tuned, then evaluated
            reward = rl_helper.calc_reward(self.rollout(w_bit_list, idx_rlout, programs))

            # 3. record, then train the agent once per layer
            states_np = np.asarray(states, np.float32)
            states_next = np.vstack([states_np[1:], states_np[:1]])
            terminals = np.zeros(nb_layers)
            terminals[-1] = 1.0
            agent.record(states_np, np.asarray(actions, np.float32),
                         float(reward[0][0]) * np.ones(nb_layers), terminals, states_next)
            agent.finalize_rlout(reward.reshape(-1))
            for _ in range(nb_layers):
                agent.train()

            if float(reward[0][0]) > reward_opt:
                reward_opt = float(reward[0][0])
                w_bits_opt = list(w_bit_list)
            self.log.info('rlout #%d: bits=%s reward=%.4f (best=%.4f)', idx_rlout, w_bit_list,
                          float(reward[0][0]), reward_opt)
            if learner.is_primary_worker():
                agent.save_search(search_path, extras={
                    'idx_rlout': idx_rlout, 'reward_best': reward_opt,
                    'w_bits_best': np.asarray(w_bits_opt, np.int32)})
        if w_bits_opt is None:  # no roll-out ran (<prefix>_nb_rlouts=0)
            self.log.warning('no rollout chose the bits; falling back to uniform %s_weight_bits',
                             self.prefix)
            w_bits_opt = [self._f('weight_bits')] * nb_layers
        # under data parallelism rank 0's decision wins
        w_bits_opt = mesh.broadcast_from_primary(np.asarray(w_bits_opt, np.float32))
        return [int(b) for b in w_bits_opt], fp_a_bits

    # ------------------------------------------------------------------

    def rollout_programs(self):
        """(train step, eval step, train iterator, validation iterator) that
        every roll-out uses: the learner's quantized steps, and the two parts
        of the train set (the rewards never come from the eval set)."""
        learner = self.learner
        schedule, _ = learner.quant_schedule()
        train_iter, val_iter = learner.dataset_train.build(enbl_trn_val_split=True)
        return (learner.build_quant_train_step(Sgd(schedule, FLAGS.momentum)),
                learner.build_quant_eval_step(), train_iter, val_iter)

    def rollout(self, w_bit_list: List[int], idx_rlout: int, programs) -> float:
        """The accuracy of one roll-out at `w_bit_list`: a copy of the
        baseline state (which stays as it was) at these weight bits and
        full-precision activations, layerwise-regressed onto the baseline
        and globally finetuned as the flags say (the finetune's generators
        seeded from rand_seed + idx_rlout and the step), then evaluated on
        min(8, nb_smpls_val // batch) validation batches."""
        learner = self.learner
        train_step, eval_step, train_iter, val_iter = programs
        state = learner.set_bits(learner.copy_state(self.baseline_state), w_bit_list,
                                 [32] * self.statistics['nb_activations'])
        if self._f('enbl_rl_layerwise_tune'):
            self.layerwise_tune(state, train_iter,
                                max(1, self._f('tune_layerwise_steps') // learner.nb_workers))
        if self._f('enbl_rl_global_tune'):
            for step in range(max(1, self._f('tune_global_steps') // learner.nb_workers)):
                seed = tune_seed(FLAGS.rand_seed, idx_rlout, step)
                state, _ = train_step(state, learner.put_batch(next(train_iter)),
                                      learner.generator(seed))
        nb_feval = max(1, min(8, learner.dataset_train.spec.nb_smpls_val
                              // learner.dataset_train.batch_size))
        accs = [eval_step(state, learner.put_batch(next(val_iter)))['accuracy']
                for _ in range(nb_feval)]
        return float(torch.stack(accs).mean())

    def layerwise_tune(self, state, iterator, nb_steps: int):
        """Regress the quantized roll-out model onto the full-precision
        baseline, `nb_steps` Adam (1e-3) steps on batches of `iterator`:
        every conv/dense output's L2 distance to the baseline's, in eval
        mode, with every layer input detached so that each kernel takes its
        own regression gradient."""
        learner = self.learner
        baseline = self.baseline_state.model
        policy_fn = learner._policy_fn()
        optimizer = torch.optim.Adam(state.model.parameters(), lr=1e-3)
        for _ in range(nb_steps):
            batch = learner.put_batch(next(iterator))
            images = learner.dataset_train.augment_batch(batch, None, False)['image']
            with torch.no_grad():
                targets = dict(capture_forward(baseline, images))
            outs = dict(capture_forward(state.model, images, stop_input_grads=True,
                                        inner=policy_fn(state)))
            loss = 0.5 * sum(torch.sum(torch.square(
                outs[p].to(torch.float32) - targets[p].to(torch.float32))) for p in targets)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            mesh.all_reduce_grads_(state.model.parameters())
            optimizer.step()
        return state
