"""RL state/action helper for weight sparsification (a copy of
pocketflow_tpu/learners/weight_sparsification/rl_helper.py, which is numpy only).

State vector per maskable layer: [one-hot layer id | 4-dim shape | #params
full | #params remaining in already-decided layers | #params in undecided
layers], max-normalized.  Actions in [0,1] map piecewise-linearly onto a
per-layer prune-ratio interval around the global target, with a running
budget constraint that forces later layers to make up any shortfall.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from pocketflow_tpu_torch.config import FLAGS


class RLHelper:
    """Maps DDPG states/actions onto per-layer pruning ratios."""

    def __init__(self, shapes: Sequence[Tuple[int, ...]], skip_head_n_tail: bool):
        nb_vars = len(shapes)
        self.nb_vars = nb_vars
        self.prune_ratios = np.zeros(nb_vars)
        self.nb_params_full = np.zeros(nb_vars)
        var_shapes = []
        for idx, shape in enumerate(shapes):
            shape = np.asarray(shape, np.float64)
            assert shape.size in (2, 4), 'invalid # of kernel dims: %d' % shape.size
            if shape.size == 2:
                shape = np.hstack((np.ones(2), shape))
            var_shapes.append(shape)
            self.nb_params_full[idx] = np.prod(shape)

        # per-layer state vectors (reference :49-61)
        self.s_dims = nb_vars + 4 + 3
        self.states = np.zeros((nb_vars, self.s_dims))
        for idx in range(nb_vars):
            self.states[idx, idx] = 1.0
            self.states[idx, nb_vars:nb_vars + 4] = var_shapes[idx]
            self.states[idx, nb_vars + 4] = self.nb_params_full[idx]
            self.states[idx, nb_vars + 6] = np.sum(self.nb_params_full[idx + 1:])
        self.state_normalizer = np.max(self.states, axis=0)
        self.state_normalizer[-2] = self.state_normalizer[-1]
        self.state_normalizer[self.state_normalizer == 0.0] = 1.0

        # per-layer ratio bounds around the global target (reference :63-72)
        pr_min = max(0.0, 1.0 - (1.0 - FLAGS.ws_prune_ratio) * 3.0)
        pr_max = 1.0 - (1.0 - FLAGS.ws_prune_ratio) / 3.0
        self.prune_ratios_min = pr_min * np.ones(nb_vars)
        self.prune_ratios_max = pr_max * np.ones(nb_vars)
        if skip_head_n_tail:
            self.prune_ratios_min[[0, -1]] = 0.0
            self.prune_ratios_max[[0, -1]] = 0.0

    def calc_state(self, idx: int) -> np.ndarray:
        state = np.copy(self.states[idx])
        state[-2] = np.sum(self.nb_params_full[:idx] * (1.0 - self.prune_ratios[:idx]))
        return (state / self.state_normalizer)[None, :]

    def calc_reward(self, accuracy: float) -> float:
        if not np.isfinite(accuracy):
            accuracy = 0.0  # diverged roll-out: worst finite reward, never NaN
        if FLAGS.ws_reward_type == 'single-obj':
            return float(accuracy)
        if FLAGS.ws_reward_type == 'multi-obj':
            return float(accuracy) * np.log(1.0 + self.calc_overall_prune_ratio())
        raise ValueError('unrecognized reward type: ' + FLAGS.ws_reward_type)

    def cvt_action_to_prune_ratio(self, idx: int, action: float) -> float:
        """Piecewise-linear action -> ratio with budget constraint (:109-161)."""
        pr_min, pr_max = self._prune_ratio_min_max(idx)
        target = FLAGS.ws_prune_ratio
        if action > 0.5:
            ratio = pr_max - (1.0 - action) / 0.5 * (pr_max - target)
        else:
            ratio = pr_min + action / 0.5 * (target - pr_min)
        self.prune_ratios[idx] = max(pr_min, min(pr_max, ratio))
        return self.prune_ratios[idx]

    def calc_overall_prune_ratio(self) -> float:
        return float(np.sum(self.nb_params_full * self.prune_ratios)
                     / np.sum(self.nb_params_full))

    def _prune_ratio_min_max(self, idx: int) -> Tuple[float, float]:
        pr_min = self.prune_ratios_min[idx]
        pr_max = self.prune_ratios_max[idx]
        if FLAGS.ws_reward_type == 'single-obj':
            # budget: even pruning all later layers at their max must still
            # reach the global target, so raise this layer's floor as needed
            pruned_max = (np.sum(self.nb_params_full[:idx] * self.prune_ratios[:idx])
                          + np.sum(self.nb_params_full[idx + 1:]
                                   * self.prune_ratios_max[idx + 1:]))
            pruned_req = np.sum(self.nb_params_full) * FLAGS.ws_prune_ratio
            ratio_req = (pruned_req - pruned_max) / self.nb_params_full[idx]
            if ratio_req > pr_max + 1e-6:
                # the reference asserts here (rl_helper.py:157-158): silently
                # clamping would reward the agent for under-pruning and the
                # global target could never be met
                raise ValueError(
                    'cannot reach the required pruning ratio %.3f: layer %d '
                    'needs ratio %.3f > max %.3f (lower --ws_prune_ratio or '
                    'raise --ws_prune_ratio_max)'
                    % (FLAGS.ws_prune_ratio, idx, ratio_req, pr_max))
            pr_min = max(pr_min, min(ratio_req, pr_max))
        return pr_min, pr_max
