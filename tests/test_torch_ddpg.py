"""The port's DDPG agent (pocketflow_tpu_torch/rl_agents/ddpg/agent.py) and
the numpy modules it copies, against the JAX package's, on the CPU.

* the copies (replay buffer, environments, both RL helpers): equal outputs
  for the same seed and the same sequence of calls;
* actions through the bridge (``ddpg_params_from_jax``): within 1e-6;
* one update (`_train`) from a bridged state, two JAX updates into the
  search (targets apart from the online nets, Adam moments non-zero), on the
  same minibatch: every tensor of the state after it (actor, critic, both
  targets, both Adams' moments) and both losses within rtol 1e-5 of JAX's,
  per tensor on the L2 norm of the difference.  Three planted faults must
  each fail that bound: a critic that also takes the actor loss's gradient,
  LayerNorms at torch's epsilon 1e-5, and Polyak averaging from the nets
  before the update.  The minibatch's states are the RL helpers' kind
  (normalized features in [0, 1], a one-hot block), scaled by 0.1 so that the
  first LayerNorm sees a variance (~1e-3) at which its epsilon shows;
* NoiseSpec, both protocols: equal stdev sequences;
* counterparts of tests/test_ddpg.py: convergence on MoveToTargetEnv,
  actions in bounds, no update before the buffer is full, the adapt
  protocol, the search checkpoint round trip and a corrupt checkpoint.
"""

import os

import jax
import numpy as np
import pytest
import torch

import pocketflow_tpu.learners.uniform_quantization.bit_optimizer  # noqa: F401  (uql_* flags)
import pocketflow_tpu.learners.weight_sparsification.pr_optimizer  # noqa: F401  (ws_* flags)
import pocketflow_tpu_torch.learners.uniform_quantization.bit_optimizer  # noqa: F401
import pocketflow_tpu_torch.learners.weight_sparsification.pr_optimizer  # noqa: F401
from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.rl_agents.ddpg import agent as jagent_lib
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core.bridge import (
    ddpg_adam_from_jax, ddpg_params_from_jax, ddpg_state_dict_from_jax)
from pocketflow_tpu_torch.rl_agents.ddpg import agent as tagent_lib

torch.set_num_threads(2)
RTOL = 1e-5
S_DIMS, A_DIMS, BATCH = 12, 1, 32


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


# ---------------------------------------------------------------------------
# the numpy copies
# ---------------------------------------------------------------------------

def _replay_buffer(pkg):
    buf = pkg.ReplayBuffer(s_dims=3, a_dims=2, buf_size=8, seed=5)
    rng = np.random.default_rng(0)
    out = [buf.is_ready]
    for i in range(13):  # wraps around the ring
        buf.append(rng.normal(size=(1, 3)), rng.normal(size=(1, 2)), [float(i)], [0.0],
                   rng.normal(size=(1, 3)))
        out.append((buf.is_ready, buf.head, buf.count))
    out += [buf.sample(5) for _ in range(3)]
    return out


def _envs(pkg):
    out = []
    for env in (pkg.MoveToTargetEnv(nb_dims=2, seed=3), pkg.PendulumEnv(seed=3)):
        out.append(env.reset())
        for i in range(6):
            out.append(env.step(np.full((1, 2 if hasattr(env, 'target') else 1), 0.3 - 0.1 * i)))
    return out


def _ws_rl_helper(pkg):
    shapes = [(3, 3, 1, 32), (3, 3, 32, 64), (3136, 1024), (1024, 10)]
    helper = pkg.RLHelper(shapes, skip_head_n_tail=False)
    out = []
    for idx, action in enumerate((0.9, 0.1, 0.6, 0.0)):
        out += [helper.calc_state(idx), helper.cvt_action_to_prune_ratio(idx, action)]
    return out + [helper.calc_overall_prune_ratio(), helper.calc_reward(0.8),
                  helper.calc_reward(float('nan'))]


def _uq_rl_helper(pkg):
    weights = [864, 18432, 36864, 640]
    shapes = [(3, 3, 3, 32), (3, 3, 32, 64), (3, 3, 64, 64), (64, 10)]
    helper = pkg.RLHelper(sum(weights) * 4, weights, shapes, random_layers=True, seed=7)
    out = []
    for actions in ((5.2, 0.4, 3.7, 6.0), (0.0, 6.0, 2.5, 1.1)):
        helper.reset()
        out.append(list(helper.layer_idxs))
        for idx, action in zip(helper.layer_idxs, actions):
            out += [helper.calc_state(idx), helper.calc_w(np.asarray([[action]]), idx)]
    return out + [helper.calc_reward(0.7)]


def _assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for key in a:
            _assert_same(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('name', ['replay_buffer', 'envs', 'ws_rl_helper', 'uq_rl_helper'])
def test_numpy_copies_match_jax(name):
    """Each copied numpy module gives JAX's outputs, exactly, for the same
    seed and calls (the replay buffer's ring, readiness and samples)."""
    import importlib
    module, fn = {
        'replay_buffer': ('rl_agents.ddpg.replay_buffer', _replay_buffer),
        'envs': ('rl_agents.envs', _envs),
        'ws_rl_helper': ('learners.weight_sparsification.rl_helper', _ws_rl_helper),
        'uq_rl_helper': ('learners.uniform_quantization.rl_helper', _uq_rl_helper)}[name]
    jmod = importlib.import_module('pocketflow_tpu.' + module)
    tmod = importlib.import_module('pocketflow_tpu_torch.' + module)
    flags = dict(ws_prune_ratio=0.6, ws_reward_type='single-obj', uql_w_bit_min=2,
                 uql_w_bit_max=8)
    with JFLAGS.scope(**flags), TFLAGS.scope(**flags):
        _assert_same(fn(tmod), fn(jmod))


# ---------------------------------------------------------------------------
# the agent against the JAX agent
# ---------------------------------------------------------------------------

def _states(rng, n):
    """RL-helper-like states: a one-hot block and features in [0, 1], x0.1."""
    states = np.zeros((n, S_DIMS), np.float32)
    states[np.arange(n), rng.integers(0, S_DIMS - 4, n)] = 1.0
    states[:, S_DIMS - 4:] = rng.uniform(size=(n, 4))
    return 0.1 * states


def _minibatch(rng):
    return {'states': _states(rng, BATCH),
            'actions': rng.uniform(size=(BATCH, A_DIMS)).astype(np.float32),
            'rewards': rng.normal(size=(BATCH, 1)).astype(np.float32),
            'terminals': (rng.uniform(size=(BATCH, 1)) < 0.2).astype(np.float32),
            'states_next': _states(rng, BATCH)}


def _adam_moments(optimizer, module):
    return {name: (optimizer.state[p]['exp_avg'].numpy(), optimizer.state[p]['exp_avg_sq'].numpy())
            for name, p in module.named_parameters()}


def _port_agent(jstate, cls=tagent_lib.DdpgAgent):
    agent = cls(s_dims=S_DIMS, a_dims=A_DIMS, nb_rlouts=10, buf_size=64, seed=0, device='cpu')
    agent.init()
    ddpg_params_from_jax(agent.actor, agent.critic, _np(jstate.actor), _np(jstate.critic))
    ddpg_params_from_jax(agent.actor_tr, agent.critic_tr, _np(jstate.actor_tr),
                         _np(jstate.critic_tr))
    ddpg_adam_from_jax(agent.opt_actor, agent.actor, _np(jstate.opt_actor[0])._asdict())
    ddpg_adam_from_jax(agent.opt_critic, agent.critic, _np(jstate.opt_critic[0])._asdict())
    return agent


def _port_record(agent, actor_loss, critic_loss):
    out = {'actor_loss': float(actor_loss), 'critic_loss': float(critic_loss)}
    for net in ('actor', 'critic', 'actor_tr', 'critic_tr'):
        for name, p in getattr(agent, net).named_parameters():
            out['%s/%s' % (net, name)] = p.detach().numpy().copy()
    for opt, net in (('opt_actor', 'actor'), ('opt_critic', 'critic')):
        for name, (mu, nu) in _adam_moments(getattr(agent, opt), getattr(agent, net)).items():
            out['%s/mu/%s' % (opt, name)], out['%s/nu/%s' % (opt, name)] = mu, nu
    return out


def _jax_record(state, actor_loss, critic_loss):
    out = {'actor_loss': float(actor_loss), 'critic_loss': float(critic_loss)}
    for net in ('actor', 'critic', 'actor_tr', 'critic_tr'):
        for name, v in ddpg_state_dict_from_jax(_np(getattr(state, net))).items():
            out['%s/%s' % (net, name)] = v.numpy()
    for opt in ('opt_actor', 'opt_critic'):
        adam = getattr(state, opt)[0]
        for key in ('mu', 'nu'):
            for name, v in ddpg_state_dict_from_jax(_np(getattr(adam, key))).items():
                out['%s/%s/%s' % (opt, key, name)] = v.numpy()
    return out


@pytest.fixture(scope='module')
def jax_update():
    """The JAX agent two updates into a search, then the compared update:
    (state before it, its minibatch, the record after it)."""
    rng = np.random.default_rng(11)
    with JFLAGS.scope(ddpg_batch_size=BATCH):
        agent = jagent_lib.DdpgAgent(s_dims=S_DIMS, a_dims=A_DIMS, nb_rlouts=10, buf_size=64,
                                     seed=0)
        agent.init()
        state = agent.state
        for _ in range(2):
            state, _, _, _ = agent._train(state, _minibatch(rng))
        batch = _minibatch(rng)
        after, actor_loss, critic_loss, _ = agent._train(state, batch)
        return state, batch, _jax_record(after, actor_loss, critic_loss)


def _failures(got, want):
    """The entries of `got` farther than RTOL * ||want|| (L2) from `want`."""
    out = {}
    for key, w in want.items():
        err = float(np.linalg.norm(np.asarray(got[key]) - w))
        if err > RTOL * float(np.linalg.norm(w)) + 1e-12:
            out[key] = err / max(float(np.linalg.norm(w)), 1e-30)
    return out


def _port_update(jax_update, cls=tagent_lib.DdpgAgent, prepare=None):
    before, batch, _ = jax_update
    agent = _port_agent(before, cls)
    if prepare is not None:
        prepare(agent)
    return _port_record(agent, *agent._train(batch))


def test_actions_clean_through_the_bridge():
    rng = np.random.default_rng(3)
    with JFLAGS.scope(ddpg_batch_size=BATCH):
        jagent = jagent_lib.DdpgAgent(s_dims=S_DIMS, a_dims=2, nb_rlouts=10, buf_size=64,
                                      a_min=0.2, a_max=0.9, seed=4)
        jagent.init()
    tagent = tagent_lib.DdpgAgent(s_dims=S_DIMS, a_dims=2, nb_rlouts=10, buf_size=64,
                                  a_min=0.2, a_max=0.9, seed=4, device='cpu')
    tagent.init()
    ddpg_params_from_jax(tagent.actor, tagent.critic, _np(jagent.state.actor),
                         _np(jagent.state.critic))
    states = rng.uniform(size=(16, S_DIMS)).astype(np.float32)
    np.testing.assert_allclose(tagent.actions_clean(states), jagent.actions_clean(states),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(KeyError):  # a leaf the bridge does not map
        ddpg_params_from_jax(tagent.actor, tagent.critic,
                             {**_np(jagent.state.actor), 'extra': {'kernel': np.zeros(2)}},
                             _np(jagent.state.critic))
    with pytest.raises(KeyError):  # the head left unset
        ddpg_params_from_jax(tagent.actor, tagent.critic,
                             {k: v for k, v in _np(jagent.state.actor).items() if k != 'head'},
                             _np(jagent.state.critic))


def test_train_update_matches_jax(jax_update):
    got = _port_update(jax_update)
    want = jax_update[2]
    assert set(got) == set(want)
    assert not _failures(got, want)


class _CriticSeesActorGradient(tagent_lib.DdpgAgent):
    def _gradients(self, batch):
        actor_loss, critic_loss, g_actor, g_critic = super()._gradients(batch)
        leak = torch.autograd.grad(-torch.mean(self.critic(batch['states'],
                                                           self.actor(batch['states']))),
                                   list(self.critic.parameters()))
        return actor_loss, critic_loss, g_actor, [g + d for g, d in zip(g_critic, leak)]


class _PolyakFromOldNets(tagent_lib.DdpgAgent):
    def _train(self, batch):
        batch = {k: self._tensor(v) for k, v in batch.items()}
        actor_loss, critic_loss, g_actor, g_critic = self._gradients(batch)
        self._polyak(self.actor, self.actor_tr)
        self._polyak(self.critic, self.critic_tr)
        self._step(self.opt_critic, self.critic, g_critic)
        self._step(self.opt_actor, self.actor, g_actor)
        return actor_loss, critic_loss


def _torch_layer_norm_epsilon(agent):
    for net in (agent.actor, agent.critic, agent.actor_tr, agent.critic_tr):
        for module in net.modules():
            if isinstance(module, tagent_lib.LayerNorm):
                module.epsilon = 1e-5


@pytest.mark.parametrize('fault', ['critic_sees_actor_gradient', 'layer_norm_epsilon_1e-5',
                                   'polyak_from_old_nets'])
def test_planted_fault_fails_the_update_bound(jax_update, fault):
    """Each fault moves at least one tensor of the state, or a loss, past
    the bound that test_train_update_matches_jax holds."""
    kwargs = {'critic_sees_actor_gradient': dict(cls=_CriticSeesActorGradient),
              'layer_norm_epsilon_1e-5': dict(prepare=_torch_layer_norm_epsilon),
              'polyak_from_old_nets': dict(cls=_PolyakFromOldNets)}[fault]
    failures = _failures(_port_update(jax_update, **kwargs), jax_update[2])
    assert failures, fault


@pytest.mark.parametrize('protocol', ['tdecy', 'adapt'])
def test_noise_spec_matches_jax(protocol):
    flags = dict(ddpg_noise_std_init=0.7, ddpg_noise_std_finl=1e-4, ddpg_noise_dst_finl=0.05,
                 ddpg_noise_adpt_rat=1.07)
    with JFLAGS.scope(**flags), TFLAGS.scope(**flags):
        specs = [jagent_lib.NoiseSpec(protocol, 37), tagent_lib.NoiseSpec(protocol, 37)]
        dists = np.random.default_rng(0).uniform(0.0, 0.1, 50)
        seqs = [[], []]
        for spec, seq in zip(specs, seqs):
            for dist in dists:
                spec.adapt(dist)
                seq.append(spec.stdev_curr)
            spec.reset()
            seq.append(spec.stdev_curr)
    assert seqs[0] == seqs[1]


# ---------------------------------------------------------------------------
# counterparts of tests/test_ddpg.py
# ---------------------------------------------------------------------------

def _agent(**kwargs):
    agent = tagent_lib.DdpgAgent(device='cpu', **kwargs)
    agent.init()
    return agent


def _run_rollout(env, agent, rlout_len, noisy=True, train=False):
    state = env.reset()
    rewards = []
    for _ in range(rlout_len):
        action = agent.actions_noisy(state) if noisy else agent.actions_clean(state)
        state_next, reward = env.step(action)
        if train:
            agent.record(state, action, reward, np.zeros((1, 1)), state_next)
            agent.train()
        rewards.append(float(reward[0, 0]))
        state = state_next
    return rewards


def test_ddpg_move_to_target_converges():
    """The optimum is a total reward of 0; an untrained or noisy roll-out
    loses 40 or more.  The trained clean policy must lose less than 12."""
    from pocketflow_tpu_torch.rl_agents.envs import MoveToTargetEnv
    nb_rlouts, rlout_len, nb_dims = 60, 40, 2
    env = MoveToTargetEnv(nb_dims=nb_dims, seed=0)
    with TFLAGS.scope(ddpg_noise_prtl='tdecy', ddpg_noise_type='param',
                      ddpg_noise_std_init=0.5, ddpg_batch_size=64):
        agent = _agent(s_dims=nb_dims, a_dims=nb_dims, nb_rlouts=nb_rlouts,
                       buf_size=rlout_len * nb_rlouts // 8, a_min=-1.0, a_max=1.0, seed=0)
        rewards = []
        for _ in range(nb_rlouts):
            agent.init_rlout()
            step_rewards = _run_rollout(env, agent, rlout_len, noisy=True, train=True)
            agent.finalize_rlout(step_rewards)
            rewards.append(sum(step_rewards))
        eval_rewards = [sum(_run_rollout(env, agent, rlout_len, noisy=False)) for _ in range(5)]
    assert np.mean(eval_rewards) > -12.0, (np.mean(eval_rewards), rewards[:5])


def test_ddpg_train_noop_until_buffer_full():
    with TFLAGS.scope(ddpg_batch_size=4):
        agent = _agent(s_dims=2, a_dims=1, nb_rlouts=10, buf_size=16, seed=0)
        actor = {k: v.clone() for k, v in agent.actor.state_dict().items()}
        assert agent.train() == (0.0, 0.0, agent.noise_spec.stdev_curr)
        assert all(torch.equal(v, agent.actor.state_dict()[k]) for k, v in actor.items())
        for _ in range(16):
            agent.record(np.zeros((1, 2)), np.zeros((1, 1)), np.zeros((1, 1)),
                         np.zeros((1, 1)), np.ones((1, 2)))
        actor_loss, critic_loss, _ = agent.train()
        assert np.isfinite(actor_loss) and np.isfinite(critic_loss)
        assert not agent.in_explore


@pytest.mark.parametrize('noise_type', ['param', 'action'])
def test_ddpg_actions_within_bounds(noise_type):
    with TFLAGS.scope(ddpg_noise_type=noise_type):
        agent = _agent(s_dims=3, a_dims=2, nb_rlouts=10, buf_size=8, a_min=0.2, a_max=0.9,
                       seed=1)
        agent.init_rlout()
        states = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
        for acts in (agent.actions_clean(states), agent.actions_noisy(states)):
            assert acts.shape == (5, 2)
            assert acts.min() >= 0.2 and acts.max() <= 0.9
        if noise_type == 'action':  # fresh noise on each call
            assert not np.array_equal(agent.actions_noisy(states), agent.actions_noisy(states))


def test_adapt_noise_protocol():
    """'adapt': the stdev shrinks when the action distance exceeds the
    target and grows below it."""
    with TFLAGS.scope(ddpg_noise_prtl='adapt', ddpg_noise_type='param', ddpg_noise_std_init=1.0,
                      ddpg_noise_dst_finl=1e-2, ddpg_noise_adpt_rat=1.05, ddpg_batch_size=8):
        agent = _agent(s_dims=3, a_dims=1, nb_rlouts=10, buf_size=16, seed=0)
        for _ in range(20):
            s = np.random.default_rng(0).normal(size=(1, 3)).astype(np.float32)
            agent.record(s, np.zeros((1, 1)), np.zeros(1), np.zeros(1), s)
        std0 = agent.noise_spec.stdev_curr
        agent.train()
        assert agent.noise_spec.stdev_curr in (std0 / 1.05, std0 * 1.05)


def test_agent_search_checkpoint_roundtrip(tmp_path):
    """save_search/restore_search keep the nets (the perturbed actor too),
    Adam states, noise generator, buffer, noise stdev and baseline."""
    with TFLAGS.scope(ddpg_batch_size=8):
        agent = _agent(s_dims=3, a_dims=2, nb_rlouts=10, buf_size=16, seed=0)
        rng = np.random.default_rng(0)
        for i in range(20):
            s = rng.normal(size=(1, 3)).astype(np.float32)
            agent.record(s, rng.uniform(size=(1, 2)), np.asarray([float(i)]), np.zeros(1), s)
        agent.finalize_rlout(np.asarray([0.7]))
        agent.train()
        agent.init_rlout()
        probe = rng.normal(size=(2, 3)).astype(np.float32)
        path = str(tmp_path / 'search.npz')
        agent.save_search(path, extras={'idx_rlout': 4})

        fresh = tagent_lib.DdpgAgent(s_dims=3, a_dims=2, nb_rlouts=10, buf_size=16, seed=99,
                                     device='cpu')
        assert fresh.restore_search(path)
        assert int(fresh.restored_extras['idx_rlout']) == 4
        np.testing.assert_array_equal(fresh.actions_clean(probe), agent.actions_clean(probe))
        np.testing.assert_array_equal(fresh.actions_noisy(probe), agent.actions_noisy(probe))
        assert fresh.reward_ema == agent.reward_ema and not fresh.in_explore
        assert fresh.memory.count == agent.memory.count
        np.testing.assert_array_equal(fresh.memory.rewards, agent.memory.rewards)
        assert not fresh.restore_search(str(tmp_path / 'missing.npz'))


def test_restore_search_survives_corrupt_and_mismatched_checkpoints(tmp_path):
    """A truncated or corrupt file, or one from an agent of other sizes (the
    port's or the JAX package's), returns False and leaves the agent as it
    was; saves are atomic (no tmp file left).  A JAX file of the same sizes
    restores (tests/test_torch_search_resume_jax.py)."""
    agent = _agent(s_dims=3, a_dims=1, nb_rlouts=4, buf_size=16, seed=0)
    probe = np.ones((1, 3), np.float32)
    before = agent.actions_clean(probe)
    path = str(tmp_path / 'search.npz')
    with open(path, 'wb') as fout:
        fout.write(b'PK\x03\x04truncated-garbage')
    assert agent.restore_search(path) is False
    other = _agent(s_dims=4, a_dims=1, nb_rlouts=4, buf_size=16, seed=1)
    other.save_search(str(tmp_path / 'other.npz'))
    assert agent.restore_search(str(tmp_path / 'other.npz')) is False
    jagent = jagent_lib.DdpgAgent(s_dims=4, a_dims=1, nb_rlouts=4, buf_size=16, seed=0)
    jagent.init()
    jagent.save_search(str(tmp_path / 'jax.npz'))
    assert agent.restore_search(str(tmp_path / 'jax.npz')) is False
    np.testing.assert_array_equal(agent.actions_clean(probe), before)
    agent.save_search(path, extras={'idx_rlout': 1})
    assert agent.restore_search(path)
    assert int(agent.restored_extras['idx_rlout']) == 1
    assert not [f for f in os.listdir(tmp_path) if '.tmp' in f]
