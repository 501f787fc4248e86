"""Per-layer pruning ratios for weight sparsification (counterpart of
pocketflow_tpu/learners/weight_sparsification/pr_optimizer.py).

Protocols (``--ws_prune_ratio_prtl``):
* ``uniform`` — every maskable layer gets the global target ratio;
* ``heurist`` — ratio_i = alpha * log(#params_i), alpha chosen so that the
  overall ratio hits the target;
* ``optimal`` — a DDPG agent proposes per-layer ratios; each roll-out's
  reward is the accuracy of the pruned model after a fast regression and
  finetune, on a held-out split of the train set.

A roll-out runs on a second model (`pruned`), loaded from the full model's
parameters and BN statistics at its start, so that the full model is never
written: the three roll-out programs below take both models as arguments.
The regression is joint: every layer's input is detached, so one summed L2
loss gives each kernel its own layerwise-regression gradient and all layers
train at once, as in the JAX package.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.core.metrics import get_logger
from pocketflow_tpu_torch.learners.capture import capture_forward, regression_paths_filter
from pocketflow_tpu_torch.learners.weight_sparsification import masking
from pocketflow_tpu_torch.learners.weight_sparsification.rl_helper import RLHelper
from pocketflow_tpu_torch.rl_agents.ddpg.agent import DdpgAgent

FLAGS.DEFINE_string('ws_save_path', './models_ws/model.ckpt', "WS: model's save path")
FLAGS.DEFINE_float('ws_prune_ratio', 0.75, 'WS: target pruning ratio')
FLAGS.DEFINE_string('ws_prune_ratio_prtl', 'optimal',
                    "WS: pruning ratio protocol ('uniform' | 'heurist' | 'optimal')")
FLAGS.DEFINE_integer('ws_nb_rlouts', 200, 'WS: # of roll-outs for the RL agent')
FLAGS.DEFINE_integer('ws_nb_rlouts_min', 50,
                     'WS: minimal # of roll-outs for the RL agent to start training')
FLAGS.DEFINE_string('ws_reward_type', 'single-obj',
                    "WS: reward type ('single-obj' OR 'multi-obj')")
FLAGS.DEFINE_float('ws_lrn_rate_rg', 3e-2, 'WS: learning rate for layerwise regression')
FLAGS.DEFINE_integer('ws_nb_iters_rg', 20, 'WS: # of iterations for layerwise regression')
FLAGS.DEFINE_float('ws_lrn_rate_ft', 3e-4, 'WS: learning rate for global fine-tuning')
FLAGS.DEFINE_integer('ws_nb_iters_ft', 400, 'WS: # of iterations for global fine-tuning')
FLAGS.DEFINE_integer('ws_nb_iters_feval', 25, 'WS: # of iterations for fast evaluation')
FLAGS.DEFINE_float('ws_mask_update_step', 500, 'WS: step size for updating the pruning mask')


def _loss_params(model: torch.nn.Module):
    """(Flax path, parameter) pairs, as the model helpers' calc_loss takes them."""
    return [(name.replace('.', '/'), p) for name, p in model.named_parameters()]


# ---------------------------------------------------------------------------
# the roll-out programs
# ---------------------------------------------------------------------------

@torch.no_grad()
def rollout_init(full_model: torch.nn.Module, pruned: torch.nn.Module,
                 ratios: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """Load the full model's parameters and BN statistics into `pruned`, mask
    it at the per-layer `ratios`; returns the masks."""
    pruned.load_state_dict(full_model.state_dict())
    params = dict(pruned.named_parameters())
    masks = masking.masks_from_ratios(params, ratios)
    masking.apply_masks_(params, masks)
    return masks


def regression_optimizer(pruned: torch.nn.Module) -> torch.optim.Adam:
    """Adam at ws_lrn_rate_rg over the maskable kernels: the only parameters
    the regression trains (the JAX package zeroes the others' gradients)."""
    params = dict(pruned.named_parameters())
    return torch.optim.Adam([params[n] for n in masking.maskable_paths(params)],
                            lr=FLAGS.ws_lrn_rate_rg)


def regression_step(learner, full_model: torch.nn.Module, pruned: torch.nn.Module,
                    masks: Dict[str, torch.Tensor], optimizer: torch.optim.Optimizer,
                    batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One step of the joint layerwise regression of `pruned` onto the full
    model's conv/dense outputs: BN in eval mode, every layer input detached,
    the loss 0.5 * sum of squared differences; the maskable kernels' masked
    gradients through Adam.  Returns the loss."""
    model_name = learner.model_name
    images = learner.dataset_train.augment_batch(batch, None, False)['image']
    with torch.no_grad():
        targets = [a for p, a in capture_forward(full_model, images)
                   if regression_paths_filter(model_name, p)]
    outs = [a for p, a in capture_forward(pruned, images, stop_input_grads=True)
            if regression_paths_filter(model_name, p)]
    loss = 0.5 * sum(torch.sum(torch.square(o.to(torch.float32) - t.to(torch.float32)))
                     for o, t in zip(outs, targets))
    params = dict(pruned.named_parameters())
    names = masking.maskable_paths(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    for name, grad in zip(names, grads):
        grad = torch.zeros_like(params[name]) if grad is None else grad
        params[name].grad = grad * masks[name].to(grad.dtype)
    mesh.all_reduce_grads_(params[n] for n in names)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return loss.detach()


def finetune_optimizer(pruned: torch.nn.Module) -> torch.optim.Adam:
    return torch.optim.Adam(pruned.parameters(), lr=FLAGS.ws_lrn_rate_ft)


def finetune_step(learner, pruned: torch.nn.Module, masks: Dict[str, torch.Tensor],
                  optimizer: torch.optim.Optimizer, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One step of the global finetune: BN in train mode (its running
    statistics move), the helper's loss, masked gradients, Adam at
    ws_lrn_rate_ft.  The augmentation draws from a generator seeded with 0
    on every step, as the JAX program's fixed key does.  Returns the loss."""
    helper = learner.model_helper
    images, labels = learner.dataset_train.augment_xy(batch, learner.generator(0), True)
    outputs = helper.forward_train(pruned, images)
    loss, _ = helper.calc_loss(labels, outputs, _loss_params(pruned))
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = dict(pruned.named_parameters())
    mesh.all_reduce_grads_(params.values())
    masking.mask_gradients_({n: p.grad for n, p in params.items()}, masks)
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def feval_step(learner, model: torch.nn.Module, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The accuracy of `model` (eval mode) on one batch, on the device."""
    helper = learner.model_helper
    images, labels = learner.dataset_eval.augment_xy(batch, None, False)
    outputs = helper.forward_eval(model, images)
    return helper.calc_loss(labels, outputs, _loss_params(model))[1]['accuracy']


# ---------------------------------------------------------------------------


class PROptimizer:
    """Computes (maskable parameter name, final prune ratio) pairs for the
    weight-sparsification learner."""

    def __init__(self, learner):
        self.learner = learner
        self.log = get_logger()

    def run(self, full_model: torch.nn.Module) -> List[Tuple[str, float]]:
        """The pairs for `full_model` (the restored baseline), by
        --ws_prune_ratio_prtl."""
        params = dict(full_model.named_parameters())
        paths = masking.maskable_paths(params)
        shapes = masking.maskable_shapes(params)
        prtl = FLAGS.ws_prune_ratio_prtl
        if prtl == 'uniform':
            pairs = [(p, float(FLAGS.ws_prune_ratio)) for p in paths]
        elif prtl == 'heurist':
            pairs = self._heurist(paths, shapes)
        elif prtl == 'optimal':
            self.learner.require_dp_only('the optimal-protocol RL search')
            pairs = self._optimal(full_model, paths, shapes)
        else:
            raise ValueError('unrecognized WS pruning ratio protocol: ' + prtl)
        for path, ratio in pairs:
            self.log.info('%s: %f', path, ratio)
        return pairs

    @staticmethod
    def _heurist(paths: Sequence[str], shapes) -> List[Tuple[str, float]]:
        nb_params = np.array([np.prod(s) for s in shapes], np.float64)
        alpha = (FLAGS.ws_prune_ratio * np.sum(nb_params)
                 / np.sum(nb_params * np.log(nb_params)))
        return [(p, float(alpha * np.log(n))) for p, n in zip(paths, nb_params)]

    # ------------------------------------------------------------------
    # 'optimal' protocol: a DDPG search over per-layer ratios
    # ------------------------------------------------------------------

    def _optimal(self, full_model: torch.nn.Module, paths: List[str], shapes):
        learner = self.learner
        skip_head_n_tail = learner.dataset_name in ('cifar_10', 'cifar10')
        rl_helper = RLHelper(shapes, skip_head_n_tail)
        agent = DdpgAgent(
            s_dims=rl_helper.s_dims, a_dims=1, nb_rlouts=FLAGS.ws_nb_rlouts,
            buf_size=len(paths) * FLAGS.ws_nb_rlouts_min, a_min=0.0, a_max=1.0,
            seed=FLAGS.rand_seed, device=learner.device)
        agent.init()
        pruned = copy.deepcopy(full_model)
        # the rewards come from a held-out split of the TRAIN set, never
        # from the eval set: a search must not tune on evaluation data
        train_iter, val_iter = learner.dataset_train.build(enbl_trn_val_split=True)

        def next_batch(iterator):
            return learner.put_batch(next(iterator))

        # resume a preempted search from its latest checkpoint
        search_path = os.path.join(os.path.dirname(FLAGS.ws_save_path) or '.', 'ddpg_search.npz')
        reward_best, ratios_best, ratios, idx_beg = -np.inf, None, None, 0
        if agent.restore_search(search_path):
            extras = agent.restored_extras
            idx_beg = int(extras.get('idx_rlout', -1)) + 1
            reward_best = float(extras.get('reward_best', -np.inf))
            arr_best = extras.get('ratios_best')
            if arr_best is not None and np.size(arr_best) == len(paths):
                ratios_best = {p: float(r) for p, r in zip(paths, arr_best)}
            self.log.info('resumed WS ratio search from %s at rlout #%d', search_path, idx_beg)

        for idx_rlout in range(idx_beg, FLAGS.ws_nb_rlouts):
            # 1. per-layer ratios from the noisy actor
            agent.init_rlout()
            states, actions = [], []
            for idx in range(len(paths)):
                state_vec = rl_helper.calc_state(idx)
                action = float(agent.actions_noisy(state_vec)[0, 0])
                rl_helper.cvt_action_to_prune_ratio(idx, action)
                states.append(state_vec[0])
                actions.append([action])
                agent.train()
            ratios = {p: float(r) for p, r in zip(paths, rl_helper.prune_ratios)}

            # 2. prune, regress, finetune, evaluate => reward
            masks = rollout_init(full_model, pruned, ratios)
            optimizer = regression_optimizer(pruned)
            for _ in range(FLAGS.ws_nb_iters_rg):
                regression_step(learner, full_model, pruned, masks, optimizer,
                                next_batch(train_iter))
            optimizer = finetune_optimizer(pruned)
            for _ in range(FLAGS.ws_nb_iters_ft):
                finetune_step(learner, pruned, masks, optimizer, next_batch(train_iter))
            accs = [feval_step(learner, pruned, next_batch(val_iter))
                    for _ in range(FLAGS.ws_nb_iters_feval)]
            accuracy = float(torch.stack(accs).mean()) if accs else float('nan')
            reward = rl_helper.calc_reward(accuracy)

            # 3. record the transitions and the baseline
            nb = len(paths)
            states_np = np.asarray(states, np.float32)
            states_next = np.vstack([states_np[1:], states_np[:1]])
            terminals = np.zeros(nb)
            terminals[-1] = 1.0
            agent.record(states_np, np.asarray(actions, np.float32), reward * np.ones(nb),
                         terminals, states_next)
            agent.finalize_rlout(np.asarray([reward]))

            if reward > reward_best:
                reward_best = reward
                ratios_best = dict(ratios)
            self.log.info('rlout #%d: reward=%.4f (best=%.4f, overall pr=%.4f)', idx_rlout,
                          reward, reward_best, rl_helper.calc_overall_prune_ratio())
            if learner.is_primary_worker():
                save_ratios = ratios_best if ratios_best is not None else ratios
                agent.save_search(search_path, extras={
                    'idx_rlout': idx_rlout, 'reward_best': reward_best,
                    'ratios_best': np.asarray([save_ratios[p] for p in paths], np.float32)})

        if ratios_best is None:
            # every reward was NaN/-inf, no roll-out ran (ws_nb_rlouts=0, or
            # a resume past the end), or the restored best did not validate:
            # the last roll-out's ratios, else the uniform target
            self.log.warning('no rollout produced a usable best ratio set; falling back to %s',
                             'the final rollout' if ratios is not None
                             else 'uniform ws_prune_ratio')
            ratios_best = (ratios if ratios is not None
                           else {p: float(FLAGS.ws_prune_ratio) for p in paths})
        # under data parallelism the ranks' rewards come from their own
        # shards and their best ratios may differ: rank 0's decision wins
        ratios = mesh.broadcast_from_primary(
            np.asarray([ratios_best[p] for p in paths], np.float32))
        return [(p, float(ratios[i])) for i, p in enumerate(paths)]
