"""DDPG agent (counterpart of pocketflow_tpu/rl_agents/ddpg/agent.py).

The same algorithm, hyper-parameters (ddpg_* flags) and host API:

* actor and critic are MLPs of (Dense, LayerNorm, relu) blocks; the actor's
  actions are sigmoid-squashed to [a_min, a_max];
* target networks follow the online ones by Polyak averaging (tau);
* parameter noise (a perturbed copy of the actor; the 'adapt' protocol
  measures the action distance of a second perturbed copy) or additive
  action noise, its stdev from `NoiseSpec` ('tdecy' | 'adapt');
* the reward baseline is an EMA subtracted from replayed rewards;
* a host-side numpy ring replay buffer; no update until it is full.

The networks, their targets and the Adam states live on the agent's device
(the learner's).  Initial weights are drawn on the host from a generator
seeded with `seed`, so a seed gives the same networks on every device; the
noise comes from a generator on the device, seeded from `seed` too.  The
layers keep Flax's names and layouts (``blocks.dense_0.kernel`` is [in,
out]), so ``core/bridge.py:ddpg_params_from_jax`` carries the JAX agent's
parameters over by name.
"""

from __future__ import annotations

import copy
import io
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core.metrics import get_logger
from pocketflow_tpu_torch.learners.abstract_learner import resolve_device
from pocketflow_tpu_torch.nn.layers import variance_scaling_
from pocketflow_tpu_torch.rl_agents.ddpg.replay_buffer import ReplayBuffer

# ddpg_* flags (names and defaults of the JAX package)
FLAGS.DEFINE_float('ddpg_tau', 0.01, "DDPG: target networks' update coefficient")
FLAGS.DEFINE_float('ddpg_gamma', 0.9, 'DDPG: reward discounting factor')
FLAGS.DEFINE_float('ddpg_lrn_rate', 1e-3, "DDPG: actor & critic networks' learning rate")
FLAGS.DEFINE_float('ddpg_loss_w_dcy', 0.0, 'DDPG: weight decaying coefficient')
FLAGS.DEFINE_integer('ddpg_record_step', 1, 'DDPG: recording step size')
FLAGS.DEFINE_integer('ddpg_batch_size', 64, 'DDPG: batch size')
FLAGS.DEFINE_boolean('ddpg_enbl_bsln_func', True, 'DDPG: enable baseline function')
FLAGS.DEFINE_float('ddpg_bsln_decy_rate', 0.95, "DDPG: baseline function's decaying rate")
FLAGS.DEFINE_integer('ddpg_actor_depth', 2, "DDPG: actor network's depth")
FLAGS.DEFINE_integer('ddpg_actor_width', 64, "DDPG: actor network's width")
FLAGS.DEFINE_integer('ddpg_critic_depth', 2, "DDPG: critic network's depth")
FLAGS.DEFINE_integer('ddpg_critic_width', 64, "DDPG: critic network's width")
FLAGS.DEFINE_string('ddpg_noise_type', 'param', "DDPG: noise type ('param' | 'action')")
FLAGS.DEFINE_string('ddpg_noise_prtl', 'tdecy', "DDPG: noise protocol ('tdecy' | 'adapt')")
FLAGS.DEFINE_float('ddpg_noise_std_init', 1e+0, "DDPG: noise's initial stdev")
FLAGS.DEFINE_float('ddpg_noise_dst_finl', 1e-2, "DDPG: action noise's final distance (adapt)")
FLAGS.DEFINE_float('ddpg_noise_adpt_rat', 1.03, "DDPG: parameter noise's adaption rate")
FLAGS.DEFINE_float('ddpg_noise_std_finl', 1e-5, "DDPG: noise's final stdev (tdecy)")
FLAGS.DEFINE_float('ddpg_rms_eps', 1e-4, "DDPG: running std's epsilon")

# flax.linen.LayerNorm's epsilon; torch.nn.LayerNorm's default is 1e-5
LN_EPSILON = 1e-6


class Dense(nn.Module):
    """flax.linen.Dense: kernel [in, out] drawn from lecun_normal, zero bias."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator):
        variance_scaling_(self.kernel, 1.0, 'fan_in', *self.kernel.shape, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return x @ self.kernel + self.bias


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm over the last axis: scale, bias, epsilon 1e-6."""

    def __init__(self, features: int):
        super().__init__()
        self.epsilon = LN_EPSILON
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.epsilon)


class _MLPBlockStack(nn.Module):
    """`depth` blocks of dense_i -> ln_i -> relu."""

    def __init__(self, in_features: int, depth: int, width: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module('dense_%d' % i, Dense(in_features if i == 0 else width, width))
            self.add_module('ln_%d' % i, LayerNorm(width))

    def forward(self, x):
        for i in range(self.depth):
            x = F.relu(getattr(self, 'ln_%d' % i)(getattr(self, 'dense_%d' % i)(x)))
        return x


def _reset(module: nn.Module, generator: torch.Generator):
    for sub in module.modules():
        if isinstance(sub, (Dense, LayerNorm)):
            sub.reset_parameters(generator)


class Actor(nn.Module):
    def __init__(self, s_dims: int, a_dims: int, a_min: float, a_max: float):
        super().__init__()
        depth, width = FLAGS.ddpg_actor_depth, FLAGS.ddpg_actor_width
        self.a_min, self.a_max = a_min, a_max
        self.blocks = _MLPBlockStack(s_dims, depth, width)
        self.head = Dense(width if depth else s_dims, a_dims)

    def forward(self, states):
        x = self.head(self.blocks(states))
        return torch.sigmoid(x) * (self.a_max - self.a_min) + self.a_min


class Critic(nn.Module):
    def __init__(self, s_dims: int, a_dims: int):
        super().__init__()
        depth, width = FLAGS.ddpg_critic_depth, FLAGS.ddpg_critic_width
        self.dense_in = Dense(s_dims, width)
        self.ln_in = LayerNorm(width)
        self.blocks = _MLPBlockStack(width + a_dims, depth, width)
        self.head = Dense(width if depth else width + a_dims, 1)

    def forward(self, states, actions):
        x = F.relu(self.ln_in(self.dense_in(states)))
        return self.head(self.blocks(torch.cat([x, actions], dim=1)))


class NoiseSpec:
    """AdaptiveNoiseSpec / TimeDecayNoiseSpec."""

    def __init__(self, protocol: str, nb_rlouts: int):
        self.protocol = protocol
        self.decy_rat = (FLAGS.ddpg_noise_std_finl / FLAGS.ddpg_noise_std_init) \
            ** (1.0 / max(nb_rlouts, 1))
        self.reset()

    def reset(self):
        self.stdev_curr = FLAGS.ddpg_noise_std_init

    def adapt(self, dst_curr: Optional[float] = None):
        if self.protocol == 'tdecy':
            self.stdev_curr *= self.decy_rat
        elif self.protocol == 'adapt':
            if dst_curr > FLAGS.ddpg_noise_dst_finl:
                self.stdev_curr /= FLAGS.ddpg_noise_adpt_rat
            else:
                self.stdev_curr *= FLAGS.ddpg_noise_adpt_rat


class DdpgAgent:
    """DDPG agent; the host API of the JAX package's DdpgAgent."""

    def __init__(self, s_dims: int, a_dims: int, nb_rlouts: int, buf_size: int,
                 a_min: float = 0.0, a_max: float = 1.0, seed: int = 0, device='cuda'):
        self.s_dims, self.a_dims = s_dims, a_dims
        self.a_min, self.a_max = float(a_min), float(a_max)
        self.nb_rlouts = nb_rlouts
        self.buf_size = buf_size
        self.seed = seed
        self.device = resolve_device(device)
        self.memory = ReplayBuffer(s_dims, a_dims, buf_size, seed)
        self.noise_spec = NoiseSpec(FLAGS.ddpg_noise_prtl, nb_rlouts)
        self.reward_ema: Optional[float] = None
        self.in_explore = True
        self.actor: Optional[Actor] = None  # set by init()
        self.restored_extras: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    # networks, noise and the update
    # ------------------------------------------------------------------

    def _adam(self, module: nn.Module) -> torch.optim.Adam:
        # optax.adam(lr): eps added outside the square root, no weight decay,
        # no amsgrad; with these settings torch's Adam takes the same step
        return torch.optim.Adam(module.parameters(), lr=FLAGS.ddpg_lrn_rate, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=0.0, amsgrad=False)

    def _tensor(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array, np.float32)).to(self.device)

    def _perturb(self, stdev: float) -> Dict[str, torch.Tensor]:
        """The actor's parameters, each (LayerNorm scales and biases too)
        plus stdev * N(0, 1) from the noise generator."""
        with torch.no_grad():
            return {name: p + stdev * torch.randn(p.shape, generator=self.noise,
                                                  device=self.device)
                    for name, p in self.actor.named_parameters()}

    @torch.no_grad()
    def _action_dist(self, states: np.ndarray, stdev: float) -> float:
        """RMS distance between clean and freshly perturbed actions (adapt)."""
        states = self._tensor(states)
        clean = self.actor(states)
        noisy = functional_call(self.actor, self._perturb(stdev), (states,))
        return float(torch.sqrt(torch.mean(torch.square(clean - noisy))))

    @staticmethod
    def _weight_decay(module: nn.Module) -> torch.Tensor:
        return FLAGS.ddpg_loss_w_dcy * sum(p.square().sum() for p in module.parameters())

    def _gradients(self, batch: Dict[str, torch.Tensor]):
        """Both losses and gradients, each from the parameters before any
        step: the actor's loss goes through the critic as it was, and the
        critic never takes the actor loss's gradient."""
        states, actions = batch['states'], batch['actions']
        with torch.no_grad():
            q_next = self.critic_tr(batch['states_next'], self.actor_tr(batch['states_next']))
            target_q = batch['rewards'] + (1.0 - batch['terminals']) * FLAGS.ddpg_gamma * q_next
        critic_loss = torch.mean(torch.square(self.critic(states, actions) - target_q))
        actor_loss = -torch.mean(self.critic(states, self.actor(states)))
        if FLAGS.ddpg_loss_w_dcy > 0:
            critic_loss = critic_loss + self._weight_decay(self.critic)
            actor_loss = actor_loss + self._weight_decay(self.actor)
        g_critic = torch.autograd.grad(critic_loss, list(self.critic.parameters()))
        g_actor = torch.autograd.grad(actor_loss, list(self.actor.parameters()))
        return actor_loss.detach(), critic_loss.detach(), g_actor, g_critic

    @staticmethod
    def _step(optimizer: torch.optim.Optimizer, module: nn.Module, grads):
        for p, g in zip(module.parameters(), grads):
            p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    @staticmethod
    @torch.no_grad()
    def _polyak(new: nn.Module, target: nn.Module):
        """target = tau * new + (1 - tau) * target, from the updated nets."""
        tau = FLAGS.ddpg_tau
        tr = list(target.parameters())
        torch._foreach_mul_(tr, 1.0 - tau)
        torch._foreach_add_(tr, torch._foreach_mul(list(new.parameters()), tau))

    def _train(self, batch: Dict[str, np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update of both networks and their targets on `batch`; returns
        (actor_loss, critic_loss) as device tensors."""
        batch = {k: self._tensor(v) for k, v in batch.items()}
        actor_loss, critic_loss, g_actor, g_critic = self._gradients(batch)
        self._step(self.opt_critic, self.critic, g_critic)
        self._step(self.opt_actor, self.actor, g_actor)
        self._polyak(self.actor, self.actor_tr)
        self._polyak(self.critic, self.critic_tr)
        return actor_loss, critic_loss

    # ------------------------------------------------------------------
    # host API
    # ------------------------------------------------------------------

    def init(self):
        """Initialize the networks, reset the buffer, noise and baseline."""
        gen = torch.Generator().manual_seed(self.seed)
        actor = Actor(self.s_dims, self.a_dims, self.a_min, self.a_max)
        critic = Critic(self.s_dims, self.a_dims)
        _reset(actor, gen)
        _reset(critic, gen)
        self.actor, self.critic = actor.to(self.device), critic.to(self.device)
        self.actor_tr = copy.deepcopy(self.actor).requires_grad_(False)
        self.critic_tr = copy.deepcopy(self.critic).requires_grad_(False)
        self.actor_perturbed = {k: v.detach().clone() for k, v in self.actor.named_parameters()}
        self.opt_actor, self.opt_critic = self._adam(self.actor), self._adam(self.critic)
        self.noise = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self.memory.reset()
        self.noise_spec.reset()
        self.reward_ema = None
        self.in_explore = True

    def init_rlout(self):
        """Refresh the noise for the coming roll-out."""
        if FLAGS.ddpg_noise_prtl == 'tdecy' and not self.in_explore:
            self.noise_spec.adapt()
        if FLAGS.ddpg_noise_type == 'param':
            self.actor_perturbed = self._perturb(self.noise_spec.stdev_curr)

    @torch.no_grad()
    def actions_noisy(self, states: np.ndarray) -> np.ndarray:
        states = self._tensor(np.atleast_2d(states))
        if FLAGS.ddpg_noise_type == 'param':
            return functional_call(self.actor, self.actor_perturbed, (states,)).cpu().numpy()
        # fresh noise on each call, clipped to the action range
        clean = self.actor(states)
        noisy = clean + self.noise_spec.stdev_curr * torch.randn(
            clean.shape, generator=self.noise, device=self.device)
        return torch.clamp(noisy, self.a_min, self.a_max).cpu().numpy()

    @torch.no_grad()
    def actions_clean(self, states: np.ndarray) -> np.ndarray:
        return self.actor(self._tensor(np.atleast_2d(states))).cpu().numpy()

    def record(self, states, actions, rewards, terminals, states_next):
        """Append transitions, every ddpg_record_step-th."""
        step = FLAGS.ddpg_record_step
        self.memory.append(np.atleast_2d(states)[::step],
                           np.atleast_2d(actions)[::step],
                           np.asarray(rewards).reshape(-1)[::step],
                           np.asarray(terminals).reshape(-1)[::step],
                           np.atleast_2d(states_next)[::step])

    def finalize_rlout(self, rewards):
        """Update the reward-EMA baseline."""
        if not FLAGS.ddpg_enbl_bsln_func:
            return
        mean_r = float(np.mean(rewards))
        if self.reward_ema is None:
            self.reward_ema = mean_r
        else:
            decay = FLAGS.ddpg_bsln_decy_rate
            self.reward_ema = decay * self.reward_ema + (1.0 - decay) * mean_r

    def train(self) -> Tuple[float, float, float]:
        """One (or zero) update; returns (actor_loss, critic_loss, stdev)."""
        if not self.memory.is_ready:
            return 0.0, 0.0, self.noise_spec.stdev_curr
        self.in_explore = False
        if FLAGS.ddpg_noise_prtl == 'adapt':
            mbatch = self.memory.sample(FLAGS.ddpg_batch_size)
            self.noise_spec.adapt(self._action_dist(mbatch['states'], self.noise_spec.stdev_curr))
        mbatch = self.memory.sample(FLAGS.ddpg_batch_size)
        if FLAGS.ddpg_enbl_bsln_func and self.reward_ema is not None:
            mbatch['rewards'] = mbatch['rewards'] - self.reward_ema
        actor_loss, critic_loss = self._train(mbatch)
        return float(actor_loss), float(critic_loss), self.noise_spec.stdev_curr

    # ------------------------------------------------------------------
    # search checkpoints
    # ------------------------------------------------------------------

    def save_search(self, path: str, extras: Optional[Dict[str, Any]] = None):
        """Checkpoint the whole search state (networks, Adam states, noise
        generator, replay buffer, noise stdev, baseline), so that a long
        search survives preemption.

        The npz layout is the JAX package's, but its 'state' entry holds the
        bytes of ``torch.save`` of the nets' and Adam states' state_dicts,
        not Flax's serialization: the port reads its own files, not the JAX
        package's (a JAX file is an unreadable one, and the search starts
        afresh).  `extras` are the caller's numpy-able values, round-tripped
        as they are; restore_search puts them in `self.restored_extras`."""
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        extras = {('x_' + k): np.asarray(v) for k, v in (extras or {}).items()}
        buffer = io.BytesIO()
        torch.save({'actor': self.actor.state_dict(), 'critic': self.critic.state_dict(),
                    'actor_tr': self.actor_tr.state_dict(),
                    'critic_tr': self.critic_tr.state_dict(),
                    'actor_perturbed': self.actor_perturbed,
                    'opt_actor': self.opt_actor.state_dict(),
                    'opt_critic': self.opt_critic.state_dict()}, buffer)
        # written to a tmp file and renamed: a preemption mid-save never
        # leaves a truncated file that would stop the resume
        if not path.endswith('.npz'):
            path = path + '.npz'
        tmp_path = path + '.tmp.npz'
        np.savez(tmp_path,
                 buf_states=self.memory.states, buf_actions=self.memory.actions,
                 buf_rewards=self.memory.rewards, buf_terminals=self.memory.terminals,
                 buf_states_next=self.memory.states_next,
                 buf_head=self.memory.head, buf_count=self.memory.count,
                 state=np.frombuffer(buffer.getvalue(), np.uint8),
                 noise=self.noise.get_state().numpy(),
                 reward_ema=-1e30 if self.reward_ema is None else self.reward_ema,
                 stdev_curr=self.noise_spec.stdev_curr, in_explore=self.in_explore, **extras)
        os.replace(tmp_path, path)

    def restore_search(self, path: str) -> bool:
        """Restore a checkpoint written by save_search; returns success.  A
        corrupt, truncated or mismatched file returns False and leaves the
        agent as it was."""
        if not path.endswith('.npz'):
            path = path + '.npz'
        if not os.path.exists(path):
            return False
        if self.actor is None:
            self.init()
        try:
            # decode everything into new objects before touching self: a
            # truncated npz often opens and fails only when an entry is read
            blob = np.load(path)
            extras = {k[2:]: blob[k] for k in blob.files if k.startswith('x_')}
            state = torch.load(io.BytesIO(blob['state'].tobytes()), map_location='cpu',
                               weights_only=True)
            nets = {}
            for name in ('actor', 'critic', 'actor_tr', 'critic_tr'):
                nets[name] = copy.deepcopy(getattr(self, name))
                nets[name].load_state_dict(state[name])  # raises on a shape mismatch
            perturbed = {k: v.to(self.device) for k, v in state['actor_perturbed'].items()}
            want = {k: v.shape for k, v in self.actor.named_parameters()}
            if {k: v.shape for k, v in perturbed.items()} != want:
                raise ValueError('perturbed actor does not match the actor')
            opts = {}
            for name, net in (('opt_actor', nets['actor']), ('opt_critic', nets['critic'])):
                opts[name] = self._adam(net)
                opts[name].load_state_dict(state[name])
            noise = torch.Generator(device=self.device)
            noise.set_state(torch.from_numpy(np.array(blob['noise'])))
            ema = float(blob['reward_ema'])
            stdev_curr = float(blob['stdev_curr'])
            in_explore = bool(blob['in_explore'])
            bufs = {k: np.array(blob['buf_' + k]) for k in
                    ('states', 'actions', 'rewards', 'terminals', 'states_next')}
            for k, arr in bufs.items():
                if arr.shape != getattr(self.memory, k).shape:
                    raise ValueError('replay buffer %s shape %s != current %s (flag change '
                                     'between runs?)' % (k, arr.shape,
                                                         getattr(self.memory, k).shape))
            head, count = int(blob['buf_head']), int(blob['buf_count'])
        except Exception as exc:  # corrupt, truncated or mismatched: start afresh
            get_logger().warning('search checkpoint %s unreadable (%s); starting the search '
                                 'from scratch', path, exc)
            return False
        self.restored_extras = extras
        self.actor, self.critic = nets['actor'], nets['critic']
        self.actor_tr, self.critic_tr = nets['actor_tr'], nets['critic_tr']
        self.actor_perturbed = perturbed
        self.opt_actor, self.opt_critic = opts['opt_actor'], opts['opt_critic']
        self.noise = noise
        self.reward_ema = None if ema <= -1e29 else ema
        self.noise_spec.stdev_curr = stdev_curr
        self.in_explore = in_explore
        for k, arr in bufs.items():
            getattr(self.memory, k)[:] = arr
        self.memory.head = head
        self.memory.count = count
        return True
