"""Channel-pruned learner, He et al. ICCV'17 + the AMC search (counterpart
of pocketflow_tpu/learners/channel_pruning/learner.py).

Modes (``--cp_prune_option``):
* ``uniform`` - every prunable conv keeps ``cp_uniform_preserve_ratio`` of its
  input channels;
* ``list``    - per-layer preserve ratios from ``cp_prune_list_file``;
* ``auto``    - AMC: a DDPG agent proposes per-layer preserve ratios under a
  global FLOPs budget (``cp_preserve_ratio``); the reward is the accuracy (or
  the FLOPs-regularized reward) of the pruned model on a held-out split of
  the train set.

Each layer is pruned by LASSO channel selection + least-squares kernel
reconstruction (channel_pruner.py), walking the layers in call order so that
later layers see the already-pruned activations.  A prune pass works on a
`copy_state` of the state it is given: the original model (the baseline, its
BN statistics included) is the reconstruction target of every layer and is
never written, so every AMC roll-out starts from the same baseline.  Only the
pruned kernel of the copy changes per layer, and its BN statistics under
``--cp_finetune``/``--cp_retrain``.  Pruning is "fake": masked input channels
stay zero through the finetune (``state.extra['masks']``, [1, 1, c_in, 1]
for a pruned kernel, 0-d elsewhere).
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.core.bridge import search_extras_from_jax
from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner, Sgd, TrainState
from pocketflow_tpu_torch.learners.channel_pruning import channel_pruner as cp_lib
from pocketflow_tpu_torch.learners.distillation_helper import DistillationHelper
from pocketflow_tpu_torch.learners.weight_sparsification import masking
from pocketflow_tpu_torch.rl_agents.ddpg.agent import DdpgAgent

FLAGS.DEFINE_string('cp_prune_option', 'auto',
                    "CP: pruning option ('uniform' | 'list' | 'auto')")
FLAGS.DEFINE_string('cp_prune_list_file', 'ratio.list',
                    'CP: file with per-layer preserve ratios')
FLAGS.DEFINE_string('cp_channel_pruned_path', './models/pruned_model.ckpt',
                    "CP: pruned model's save path")
FLAGS.DEFINE_string('cp_best_path', './models/best_model.ckpt',
                    "CP: best pruned model's save path")
FLAGS.DEFINE_string('cp_original_path', './models/original_model.ckpt',
                    "CP: original model's save path")
FLAGS.DEFINE_float('cp_preserve_ratio', 0.5, 'CP: desired FLOPs preserve ratio')
FLAGS.DEFINE_float('cp_uniform_preserve_ratio', 0.6,
                   'CP: per-layer preserve ratio (uniform mode)')
FLAGS.DEFINE_float('cp_noise_tolerance', 0.15,
                   'CP: noise tolerance bounding the FLOPs-policy reward')
FLAGS.DEFINE_float('cp_lrn_rate_ft', 1e-4, 'CP: learning rate for global fine-tuning')
FLAGS.DEFINE_boolean('cp_finetune_schedule', False,
                     'CP: fine-tune on the model\'s full piecewise LR profile '
                     '(compressed to the fine-tune length, as CPR does) '
                     'instead of the reference\'s constant cp_lrn_rate_ft — '
                     'closes most of the reference\'s CP-vs-CPR accuracy gap')
FLAGS.DEFINE_float('cp_nb_iters_ft_ratio', 0.2,
                   'CP: ratio of total iterations for global fine-tuning')
FLAGS.DEFINE_boolean('cp_finetune', False, 'CP: finetune between list groups')
FLAGS.DEFINE_boolean('cp_retrain', False, 'CP: retrain between list groups')
FLAGS.DEFINE_integer('cp_list_group', 1000, 'CP: # of iterations for fast evaluation')
FLAGS.DEFINE_integer('cp_nb_rlouts', 200, 'CP: # of roll-outs for the RL agent')
FLAGS.DEFINE_integer('cp_nb_rlouts_min', 50,
                     'CP: min # of roll-outs before the agent trains')
FLAGS.DEFINE_string('cp_reward_policy', 'accuracy',
                    "CP: reward policy ('accuracy' | 'flops')")


class AmcRLHelper:
    """AMC states + FLOPs-budget action constraint
    (reference channel_pruner.py:108-213)."""

    def __init__(self, specs, preserve_ratio: float, ratio_min: float = 0.2):
        self.specs = specs
        self.nb_layers = len(specs)
        self.flops = np.asarray([s['flops'] for s in specs], np.float64)
        self.total_flops = float(self.flops.sum())
        self.desired_preserve = preserve_ratio * self.total_flops
        self.ratio_min = ratio_min
        # state: [idx, c_out, c_in, H, W, stride, flops, decided, rest, prev_a]
        self.s_dims = 10
        self.reset()

    def reset(self):
        self.ratios = np.ones(self.nb_layers)
        self.decided = np.zeros(self.nb_layers, bool)
        self.prev_action = 1.0

    def calc_state(self, idx: int) -> np.ndarray:
        s = self.specs[idx]
        h, w, c_in, c_out = s['kernel_shape']
        decided_flops = float(np.sum(self.flops[self.decided] * self.ratios[self.decided]))
        rest_flops = float(np.sum(self.flops[~self.decided]))
        state = np.array([
            idx / max(1, self.nb_layers - 1), c_out / 1024.0, c_in / 1024.0,
            s['out_shape'][1] / 256.0, s['out_shape'][2] / 256.0,
            s['strides'][0] / 4.0, s['flops'] / max(self.total_flops, 1.0),
            decided_flops / max(self.total_flops, 1.0),
            rest_flops / max(self.total_flops, 1.0), self.prev_action,
        ], np.float32)
        return state[None, :]

    def constrain_action(self, idx: int, action: float) -> float:
        """FLOPs budget: even pruning all later layers to ratio_min must keep
        total preserved FLOPs <= desired (reference __action_constraint)."""
        action = min(1.0, max(0.0, float(action)))
        decided_flops = float(np.sum(self.flops[self.decided] * self.ratios[self.decided]))
        later = [j for j in range(self.nb_layers) if not self.decided[j] and j != idx]
        later_min = float(np.sum(self.flops[later]) * self.ratio_min)
        this = float(self.flops[idx])
        max_action = (self.desired_preserve - decided_flops - later_min) / max(this, 1.0)
        # budget cap from above, ratio_min floor from below (the AMC lbound:
        # the later_min accounting above assumes every layer keeps >= ratio_min)
        action = max(self.ratio_min, min(action, max(self.ratio_min, max_action)))
        self.ratios[idx] = action
        self.decided[idx] = True
        self.prev_action = action
        return action

    def preserved_flops(self) -> float:
        return float(np.sum(self.flops * self.ratios))

    def calc_reward(self, accuracy: float) -> float:
        if not np.isfinite(accuracy):
            accuracy = 0.0  # diverged roll-out: worst finite reward, never NaN
        if FLAGS.cp_reward_policy == 'accuracy':
            return float(accuracy)
        # reward = -max(tol, 1-acc) * log(flops) (reference learner.py:611-621)
        return float(-max(FLAGS.cp_noise_tolerance, 1.0 - accuracy)
                     * math.log(max(self.preserved_flops(), 2.0)))


def _merge_topk(candidates, reward, ratios, k: int = 5, min_dist: float = 0.05):
    """Keep the K best (reward, ratios) pairs, pairwise distinct (mean
    |delta-ratio| >= min_dist) so adjacent roll-outs of a converged policy
    don't fill every slot with near-duplicates: a candidate too close to an
    already-kept better one is dropped."""
    merged = []
    for r, rs in sorted(candidates + [(float(reward), list(ratios))], key=lambda t: -t[0]):
        vec = np.asarray(rs, np.float64)
        if any(float(np.mean(np.abs(np.asarray(kept, np.float64) - vec))) < min_dist
               for _, kept in merged):
            continue
        merged.append((r, rs))
        if len(merged) >= k:
            break
    return merged


def kernel_masks(model: torch.nn.Module, chn_masks: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Masks of every parameter: [1, 1, c_in, 1] fp32 for the kernel of each
    conv path in `chn_masks` (a [c_in] mask), 0-d ones elsewhere."""
    out = {}
    for name, p in model.named_parameters():
        path, leaf = name.rsplit('.', 1) if '.' in name else ('', name)
        mask = chn_masks.get(path.replace('.', '/')) if leaf == 'kernel' else None
        out[name] = (mask.to(torch.float32).reshape(1, 1, -1, 1).to(p.device) if mask is not None
                     else torch.ones((), dtype=torch.float32, device=p.device))
    return out


class ChannelPrunedLearner(AbstractLearner):
    """Channel pruning learner with uniform / list / AMC-auto strategies."""

    def __init__(self, sm_writer, model_helper, device='cuda'):
        super().__init__(sm_writer, model_helper, device)
        self.helper_dst = None
        if FLAGS.enbl_dst:
            self.helper_dst = DistillationHelper(model_helper, self.device)
        self.pruner: Optional[cp_lib.ChannelPruner] = None
        self.specs: Optional[List[dict]] = None
        # filled by search_ratios_rl: top-K distinct (reward, ratios) pairs,
        # and each roll-out's seconds by part
        self.search_topk: List[tuple] = []
        self.rollout_times: List[Dict[str, float]] = []
        self._cp_train_iter = None

    # ------------------------------------------------------------------

    def _setup_pruner(self, state: TrainState):
        sample = self.put_batch(self.dataset_train.peek_batch(2))
        images = self.dataset_train.augment_images(sample, None, False)
        specs = cp_lib.conv_layer_specs(state.model, images)
        # the first conv is never pruned (its input is the image)
        self.specs = [s for s in specs if s['kernel_shape'][2] > 3]
        self.pruner = cp_lib.ChannelPruner(self.dataset_train, self.specs)

    def _ratio_list(self) -> List[float]:
        nb = len(self.specs)
        if FLAGS.cp_prune_option == 'uniform':
            return [FLAGS.cp_uniform_preserve_ratio] * nb
        if FLAGS.cp_prune_option == 'list':
            with open(FLAGS.cp_prune_list_file) as fin:
                text = fin.read().replace('\n', ',')
            ratios = [float(s) for s in text.split(',') if s.strip()]
            if len(ratios) != nb:
                raise ValueError('cp_prune_list_file has %d ratios but the model has %d '
                                 'prunable conv layers' % (len(ratios), nb))
            return ratios
        raise ValueError('unexpected prune option: ' + FLAGS.cp_prune_option)

    def _train_batches(self):
        """One device-batch iterator over the train set for the whole
        search: a fresh build() per roll-out would start another prefetch
        thread each time."""
        if self._cp_train_iter is None:
            self._cp_train_iter = self.device_prefetch(self.dataset_train.build())
        return self._cp_train_iter

    def prune_with_ratios(self, state: TrainState,
                          ratios: List[float]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Prune each conv of a copy of `state` at its preserve ratio, in
        order; later layers sample activations from the already-pruned copy
        and regress toward `state`'s model, which is left unchanged.

        Between layers, ``--cp_finetune`` runs a short masked finetune on the
        task loss, as does ``--cp_retrain`` (reference
        __prune_and_finetune_list, learner.py:602-609; group length
        ``cp_list_group`` iterations over the layers).  Returns (the pruned
        state with its masks in extra['masks'], the masks)."""
        pruned = self.copy_state(state)
        orig, cur = state.model, pruned.model
        batches = self._train_batches()
        params = dict(cur.named_parameters())
        chn_masks: Dict[str, torch.Tensor] = {}
        for spec, ratio in zip(self.specs, ratios):
            path = spec['path']
            c_in = spec['kernel_shape'][2]
            if max(1, int(math.ceil(ratio * c_in))) >= c_in:
                # nothing to prune: skip the feature collection
                chn_masks[path] = torch.ones(c_in, device=self.device)
                self.log.info('layer %s: kept %d/%d channels (target %.2f, no pruning)',
                              path, c_in, c_in, ratio)
                continue
            X, Y = self.pruner.collect(spec, orig, cur, batches,
                                       self.generator(self.next_seed()))
            kernel = params[path.replace('/', '.') + '.kernel']
            new_kernel, idxs = self.pruner.prune_layer(spec, kernel, X, Y, ratio)
            del X, Y
            with torch.no_grad():
                kernel.copy_(new_kernel)
            chn_masks[path] = idxs.to(torch.float32)
            self.log.info('layer %s: kept %d/%d channels (target %.2f)',
                          path, int(idxs.sum()), c_in, ratio)
            if FLAGS.cp_finetune or FLAGS.cp_retrain:
                self._group_finetune(pruned, chn_masks, batches)
        # each rank sampled its own shard, so its channels and kernels may
        # differ: rank 0's parameters, BN statistics and masks on every rank
        mesh.broadcast_module_(cur)
        chn_masks = mesh.broadcast_from_primary(chn_masks)
        masks = kernel_masks(cur, chn_masks)
        return self.set_extra(pruned, {'masks': masks}), masks

    def _group_finetune(self, pruned: TrainState, chn_masks: Dict[str, torch.Tensor], batches):
        """cp_list_group / #layers masked SGD steps on the task loss (at
        cp_lrn_rate_ft, fresh momentum) of the partly pruned model; its BN
        statistics move."""
        tx = Sgd(lambda step: FLAGS.cp_lrn_rate_ft, FLAGS.momentum)
        group = TrainState(step=0, model=pruned.model, optimizer=tx.init(pruned.model),
                           extra={'masks': kernel_masks(pruned.model, chn_masks)})
        grad_transform, post_update = masking.masked_update_hooks(pruned.model)
        step = self.build_train_step(tx, grad_transform_fn=grad_transform,
                                     post_update_fn=post_update)
        nb_iters = max(1, FLAGS.cp_list_group // max(1, self.nb_workers)
                       // max(1, len(self.specs)))
        base_seed = self.next_seed()
        for i in range(nb_iters):
            step(group, next(batches), self.generator(base_seed + i))

    # ------------------------------------------------------------------
    # AMC auto mode (reference __prune_and_finetune_auto/__prune_rl)
    # ------------------------------------------------------------------

    def search_ratios_rl(self, state: TrainState) -> List[float]:
        rl_helper = AmcRLHelper(self.specs, FLAGS.cp_preserve_ratio)
        agent = DdpgAgent(
            s_dims=rl_helper.s_dims, a_dims=1, nb_rlouts=FLAGS.cp_nb_rlouts,
            buf_size=max(1, len(self.specs)) * max(1, FLAGS.cp_nb_rlouts_min),
            a_min=0.0, a_max=1.0, seed=FLAGS.rand_seed, device=self.device)
        agent.init()
        eval_step = self.build_eval_step()
        # the rewards come from a held-out split of the TRAIN set, never the
        # eval set (reference channel_pruning/learner.py:137-142)
        _, val_iter = self.dataset_train.build(enbl_trn_val_split=True)
        # the whole val split (at most 12 batches): the reward is the search
        # signal AND the best-roll-out selector
        nb_feval = max(1, min(
            12, self.dataset_train.spec.nb_smpls_val // self.dataset_train.batch_size))

        # resume a preempted search from its latest checkpoint
        search_path = os.path.join(os.path.dirname(FLAGS.cp_best_path) or '.', 'ddpg_search.npz')
        best_reward, best_ratios, ratios, idx_beg = -np.inf, None, None, 0
        # top-K (reward, ratios) candidates by fast-eval reward, for callers
        # that re-rank them by fully finetuned accuracy
        top_candidates: List[tuple] = []
        extras = None
        if agent.restore_search(search_path):
            extras = agent.restored_extras
        else:
            # a search the JAX package wrote: its progress resumes, with a
            # fresh agent (its networks are Flax bytes)
            extras = search_extras_from_jax(search_path)
        if extras is not None:
            idx_beg = int(extras.get('idx_rlout', -1)) + 1
            best_reward = float(extras.get('reward_best', -np.inf))
            arr_best = extras.get('ratios_best')
            if arr_best is not None and np.size(arr_best) == len(self.specs):
                best_ratios = [float(r) for r in arr_best]
            rk, rt = extras.get('rewards_topk'), extras.get('ratios_topk')
            if rk is not None and rt is not None \
                    and np.ndim(rt) == 2 and np.shape(rt)[1] == len(self.specs):
                top_candidates = [(float(r), [float(x) for x in row])
                                  for r, row in zip(np.ravel(rk), rt)]
            self.log.info('resumed AMC ratio search from %s at rlout #%d', search_path, idx_beg)

        for idx_rlout in range(idx_beg, FLAGS.cp_nb_rlouts):
            rl_helper.reset()
            agent.init_rlout()
            states, actions = [], []
            for idx in range(len(self.specs)):
                s = rl_helper.calc_state(idx)
                a = float(agent.actions_noisy(s)[0, 0])
                a = rl_helper.constrain_action(idx, a)
                states.append(s[0])
                actions.append([a])
                agent.train()
            ratios = list(rl_helper.ratios)

            self.pruner.timings.clear()
            start = time.perf_counter()
            pruned_state, _ = self.prune_with_ratios(state, ratios)
            feval_start = time.perf_counter()
            accs = [eval_step(pruned_state, self.put_batch(next(val_iter)))['accuracy']
                    for _ in range(nb_feval)]
            reward = rl_helper.calc_reward(float(torch.stack(accs).mean()))
            del pruned_state
            end = time.perf_counter()
            self.rollout_times.append({**self.pruner.timings, 'feval': end - feval_start,
                                       'total': end - start})

            nb = len(self.specs)
            states_np = np.asarray(states, np.float32)
            states_next = np.vstack([states_np[1:], states_np[:1]])
            terminals = np.zeros(nb)
            terminals[-1] = 1.0
            agent.record(states_np, np.asarray(actions, np.float32), reward * np.ones(nb),
                         terminals, states_next)
            agent.finalize_rlout(np.asarray([reward]))
            if reward > best_reward:
                best_reward, best_ratios = reward, ratios
            if np.isfinite(reward):
                top_candidates = _merge_topk(top_candidates, reward, ratios)
            self.log.info('rlout #%d: reward=%.4f (best=%.4f) preserve=%.3f ratios=%s',
                          idx_rlout, reward, best_reward,
                          rl_helper.preserved_flops() / rl_helper.total_flops,
                          np.round(ratios, 3).tolist())
            if self.is_primary_worker():
                agent.save_search(search_path, extras={
                    'idx_rlout': idx_rlout, 'reward_best': best_reward,
                    'ratios_best': np.asarray(
                        best_ratios if best_ratios is not None else ratios, np.float32),
                    'rewards_topk': np.asarray([r for r, _ in top_candidates], np.float32),
                    'ratios_topk': np.asarray([rs for _, rs in top_candidates], np.float32)})
        self.search_topk = list(top_candidates)
        if best_ratios is None:
            # every reward was NaN/-inf, or a resume landed past cp_nb_rlouts
            # with an unusable restored ratio list and the loop never ran
            self.log.warning('no rollout produced a finite best reward; falling back to %s',
                             'the final rollout' if ratios is not None
                             else 'uniform cp_preserve_ratio')
            best_ratios = (ratios if ratios is not None
                           else [FLAGS.cp_preserve_ratio] * len(self.specs))
        # under data parallelism rank 0's decision wins
        best_ratios = mesh.broadcast_from_primary(np.asarray(best_ratios, np.float32))
        return [float(r) for r in best_ratios]

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def train(self) -> TrainState:
        self.require_dp_only('the LASSO prune/search phase')
        state, _, _ = self.init_state()
        state, _ = self.restore_baseline(state)
        self._setup_pruner(state)

        if FLAGS.cp_prune_option == 'auto':
            ratios = self.search_ratios_rl(state)
        else:
            ratios = self._ratio_list()
        state = self.prune_and_finetune(state, ratios)
        self.run_eval_loop(state, self.build_eval_step())
        return state

    def prune_and_finetune(self, state: TrainState, ratios: List[float]) -> TrainState:
        """Prune to the given per-layer preserve ratios, then finetune
        globally with masked gradients (reference __finetune_pruned_model,
        learner.py:313-379: constant cp_lrn_rate_ft).  With
        --cp_finetune_schedule the model's piecewise profile is replayed
        compressed into the finetune window."""
        state, _ = self.prune_with_ratios(state, ratios)
        schedule, nb_iters = self.setup_lrn_rate(self.global_batch_size)
        nb_iters_ft = max(1, int(nb_iters * FLAGS.cp_nb_iters_ft_ratio))
        if FLAGS.cp_finetune_schedule:
            rate = float(nb_iters) / float(nb_iters_ft)
            # the JAX schedule compares the scaled step itself with the
            # integer boundaries: s > b exactly when ceil(s) > b
            tx_ft = Sgd(lambda step: schedule(math.ceil(step * rate)), FLAGS.momentum)
            state.step = 0
        else:
            tx_ft = Sgd(lambda step: FLAGS.cp_lrn_rate_ft, FLAGS.momentum)
        state.optimizer = tx_ft.init(state.model)
        grad_transform, post_update = masking.masked_update_hooks(state.model)
        loss_extra = self.helper_dst.loss_extra_fn() if self.helper_dst else None
        train_step = self.build_train_step(tx_ft, loss_extra_fn=loss_extra,
                                           grad_transform_fn=grad_transform,
                                           post_update_fn=post_update)
        eval_step = self.build_eval_step()
        return self.run_train_loop(state, train_step, nb_iters=nb_iters_ft,
                                   save_path=FLAGS.cp_channel_pruned_path,
                                   eval_fn=lambda s: self.run_eval_loop(s, eval_step))

    def evaluate(self) -> Dict[str, float]:
        state, _, _ = self.init_state()
        self._setup_pruner(state)
        masks = kernel_masks(state.model, {s['path']: torch.ones(s['kernel_shape'][2])
                                            for s in self.specs})
        state = self.set_extra(state, {'masks': masks})
        restored = self.restore_model(state, FLAGS.cp_channel_pruned_path)
        if restored is None:
            raise FileNotFoundError('no checkpoint found under ' + FLAGS.cp_channel_pruned_path)
        metrics = self.run_eval_loop(restored, self.build_eval_step())
        return {**metrics, **self.eval_map(restored)}
