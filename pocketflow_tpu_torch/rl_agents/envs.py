"""Synthetic environments for DDPG convergence testing (a copy of
pocketflow_tpu/rl_agents/envs.py, which is numpy only).

Move-to-target has a closed-form optimum (total reward 0), so it validates
agent convergence without any external dependency; Pendulum is re-implemented
directly (classic dynamics) instead of importing gym.
"""

from __future__ import annotations

import numpy as np


class MoveToTargetEnv:
    """reward := |x-t| - |x'-t| - |x-x'|; optimum total reward = 0
    (move_to_target.py:34-65)."""

    def __init__(self, nb_dims: int = 2, seed: int = 0):
        self.nb_dims = nb_dims
        self.x_lbnd, self.x_ubnd = -10.0, 10.0
        self.target = np.zeros((1, nb_dims))
        self._rng = np.random.default_rng(seed)
        self.x_curr = None

    def reset(self) -> np.ndarray:
        self.x_curr = self._rng.uniform(self.x_lbnd, self.x_ubnd, (1, self.nb_dims))
        return self.x_curr

    def step(self, action):
        x_next = self.x_curr + action
        reward = (np.linalg.norm(self.x_curr - self.target)
                  - np.linalg.norm(x_next - self.target)
                  - np.linalg.norm(self.x_curr - x_next))
        self.x_curr = x_next
        return self.x_curr, reward * np.ones((1, 1))


class PendulumEnv:
    """Classic pendulum swing-up (dynamics of gym Pendulum-v0, no gym dep)."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self.th = 0.0
        self.thdot = 0.0

    def reset(self) -> np.ndarray:
        self.th = self._rng.uniform(-np.pi, np.pi)
        self.thdot = self._rng.uniform(-1.0, 1.0)
        return self._obs()

    def _obs(self):
        return np.asarray([[np.cos(self.th), np.sin(self.th), self.thdot]], np.float32)

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        th, thdot = self.th, self.thdot
        angle_norm = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = angle_norm ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot_new = thdot + (3 * self.G / (2 * self.L) * np.sin(th)
                             + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        thdot_new = np.clip(thdot_new, -self.MAX_SPEED, self.MAX_SPEED)
        self.th = th + thdot_new * self.DT
        self.thdot = thdot_new
        return self._obs(), -cost * np.ones((1, 1))
