"""RL helper for uniform quantization — bit-budget ("duty") bookkeeping (a copy
of pocketflow_tpu/learners/uniform_quantization/rl_helper.py, which is numpy only).

Actions in [0, w_bit_max - w_bit_min] map to integer bit-widths; a running
budget of ``total_bits = total_num_weights * uql_equivalent_bits`` forces the
final layer to absorb whatever budget remains.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

import numpy as np

from pocketflow_tpu_torch.config import FLAGS


class RLHelper:
    """States/actions <-> per-layer weight bit-widths under a bit budget."""

    def __init__(self, total_bits: int, num_weights: Sequence[int],
                 shapes: Sequence[Tuple[int, ...]], random_layers: bool = False,
                 seed: int = 0, bit_min: int = None, bit_max: int = None):
        self.bit_min = FLAGS.uql_w_bit_min if bit_min is None else bit_min
        self.bit_max = FLAGS.uql_w_bit_max if bit_max is None else bit_max
        self.nb_vars = len(num_weights)
        self.num_weights = list(num_weights)
        self.total_num_weights = sum(num_weights)
        self.s_dims = self.nb_vars + 6
        self.total_bits = total_bits
        self.random_layers = random_layers
        self.layer_idxs = list(range(self.nb_vars))
        self._rand = random.Random(seed)

        var_shapes = []
        for shape in shapes:
            shape = np.asarray(shape, np.float64)
            assert shape.size in (2, 4), 'kernel must be 2-d (fc) or 4-d (conv)'
            if shape.size == 2:
                shape = np.hstack((np.ones(2), shape))
            var_shapes.append(shape)

        self.states = np.zeros((self.nb_vars, self.s_dims))
        for idx in range(self.nb_vars):
            self.states[idx, idx] = 1.0
            self.states[idx, self.nb_vars:self.nb_vars + 4] = var_shapes[idx]
            self.states[idx, self.nb_vars + 4] = (
                self.num_weights[idx] / np.max(self.num_weights))
            self.states[idx, self.nb_vars + 5] = (
                np.sum(self.num_weights[idx + 1:]) / self.total_num_weights)
        self.reset()

    def reset(self):
        self.w_bits_used = 0
        self.quantized_layers = 0
        self.num_weights_to_quantize = self.total_num_weights
        if self.random_layers:
            self._rand.shuffle(self.layer_idxs)

    def calc_state(self, idx: int) -> np.ndarray:
        return np.copy(self.states[idx])[None, :]

    @staticmethod
    def calc_reward(accuracy: float) -> np.ndarray:
        if not np.isfinite(accuracy):
            accuracy = 0.0  # diverged roll-out: worst finite reward, never NaN
        return float(accuracy) * np.ones((1, 1))

    def _calc_w_duty(self, idx: int) -> float:
        duty = (self.total_bits - self.w_bits_used
                - self.num_weights_to_quantize * self.bit_min)
        if duty < 0:
            raise ValueError(
                'bit budget infeasible at layer %d: remaining budget %d < '
                '%d weights x bit_min=%d (raise --*_equivalent_bits or lower '
                '--*_w_bit_min)' % (idx, self.total_bits - self.w_bits_used,
                                    self.num_weights_to_quantize, self.bit_min))
        return duty

    def calc_w(self, action: np.ndarray, idx: int) -> np.ndarray:
        """Clamp the proposed bits to what the remaining budget allows."""
        action = np.asarray(action, np.float64).reshape(1, 1)
        duty = self._calc_w_duty(idx)
        if self.quantized_layers != self.nb_vars - 1:
            action = np.round(action) + self.bit_min
            action = np.minimum(
                action, self.bit_min + np.floor(duty / self.num_weights[idx]))
        else:  # last layer: spend the whole remaining budget
            action = np.floor(
                (self.total_bits - self.w_bits_used) / self.num_weights[idx]
            ) * np.ones((1, 1))
            # the duty feasibility check above guarantees >= bit_min up to
            # rounding; clamp so a tight budget can never emit sub-bit_min
            # (e.g. 1-bit) layers silently
            action = np.maximum(action, self.bit_min)
        action = np.minimum(action, self.bit_max)
        self.w_bits_used += action[0][0] * self.num_weights[idx]
        self.num_weights_to_quantize -= self.num_weights[idx]
        self.quantized_layers += 1
        return action
