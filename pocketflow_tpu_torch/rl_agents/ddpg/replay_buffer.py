"""Experience replay buffer (a copy of pocketflow_tpu/rl_agents/ddpg/replay_buffer.py,
which is numpy only; the port imports nothing of the JAX package).

Ring buffer over host NumPy arrays; `is_ready` only once the buffer is full,
matching the reference's sample-only-when-full behavior.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class ReplayBuffer:
    def __init__(self, s_dims: int, a_dims: int, buf_size: int, seed: int = 0):
        self.buf_size = int(buf_size)
        self.states = np.zeros((buf_size, s_dims), np.float32)
        self.actions = np.zeros((buf_size, a_dims), np.float32)
        self.rewards = np.zeros((buf_size, 1), np.float32)
        self.terminals = np.zeros((buf_size, 1), np.float32)
        self.states_next = np.zeros((buf_size, s_dims), np.float32)
        self._rng = np.random.default_rng(seed)
        self.reset()

    def reset(self):
        self.head = 0
        self.count = 0

    @property
    def is_ready(self) -> bool:
        return self.count >= self.buf_size

    def append(self, states, actions, rewards, terminals, states_next):
        states = np.atleast_2d(np.asarray(states, np.float32))
        n = states.shape[0]
        idxs = (self.head + np.arange(n)) % self.buf_size
        self.states[idxs] = states
        self.actions[idxs] = np.asarray(actions, np.float32).reshape(n, -1)
        self.rewards[idxs] = np.asarray(rewards, np.float32).reshape(n, 1)
        self.terminals[idxs] = np.asarray(terminals, np.float32).reshape(n, 1)
        self.states_next[idxs] = np.asarray(states_next, np.float32).reshape(n, -1)
        self.head = int((self.head + n) % self.buf_size)
        self.count = min(self.count + n, self.buf_size)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idxs = self._rng.integers(0, self.count, size=batch_size)
        return {
            'states': self.states[idxs],
            'actions': self.actions[idxs],
            'rewards': self.rewards[idxs].copy(),
            'terminals': self.terminals[idxs],
            'states_next': self.states_next[idxs],
        }
