"""Resuming a search from a checkpoint the JAX package's DDPG agent wrote
(pocketflow_tpu_torch/rl_agents/ddpg/agent.py:restore_search), on the CPU.

* A JAX agent fills its buffer, takes three updates, two reward-baseline
  updates and a noise refresh, and writes ddpg_search.npz.  The port's
  agent restores it: the actor, the critic, both targets and the perturbed
  actor, both Adam states (step counts and both moments), the buffer (rows,
  head, count), reward_ema, stdev_curr and in_explore equal JAX's exactly.
  The JAX agent's PRNG key has no torch counterpart: the port's noise
  generator restarts from the agent's seed (seed + 1, as ``init`` seeds it).
* The restored agent's clean actions and its noisy ones (parameter noise:
  the restored perturbed actor, no fresh draw) are within 1e-6 of JAX's on
  fixed states; one update on a fixed minibatch leaves every tensor of the
  state (the nets, the targets, both Adams' moments) and both losses within
  rtol 1e-5 of JAX's on the L2 norm (test_torch_ddpg.py's update bound).
* The AMC, bit and WS searches each resume at JAX's roll-out index with
  the restored agent: a JAX file with the search's own agent sizes at its
  path, idx_rlout 2 of 4 roll-outs; the agent right after the restore acts
  as JAX's, and the search runs the last roll-out only.
"""

import os
import sys

import numpy as np
import pytest
import torch

import pocketflow_tpu.learners.uniform_quantization.bit_optimizer  # noqa: F401  (uql_* flags)
import pocketflow_tpu.learners.weight_sparsification.pr_optimizer  # noqa: F401  (ws_* flags)
import pocketflow_tpu_torch.learners.channel_pruning.learner  # noqa: F401  (cp_* flags)
import pocketflow_tpu_torch.learners.uniform_quantization.learner  # noqa: F401  (uql_* flags)
import pocketflow_tpu_torch.learners.weight_sparsification.learner  # noqa: F401  (ws_* flags)
from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.rl_agents.ddpg import agent as jagent_lib
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core.bridge import ddpg_state_dict_from_jax
from pocketflow_tpu_torch.rl_agents.ddpg import agent as tagent_lib
from test_torch_ddpg import (
    A_DIMS, BATCH, S_DIMS, _failures, _jax_record, _minibatch, _np, _port_record, _states)

torch.set_num_threads(2)
BUF = 64
RESUME_AT, NB_RLOUTS = 2, 4  # the JAX search saved roll-out #2 of 4


@pytest.fixture(autouse=True)
def _port_flags(monkeypatch):
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def write_jax_search(path, s_dims, a_dims, nb_rlouts, buf_size, a_min=0.0, a_max=1.0,
                     extras=None, nb_updates=3, seed=0):
    """A JAX agent with its buffer full, `nb_updates` updates, two baseline
    updates and a noise refresh, saved to `path`; returns the agent."""
    rng = np.random.default_rng(5)
    with JFLAGS.scope(ddpg_batch_size=min(BATCH, buf_size)):
        agent = jagent_lib.DdpgAgent(s_dims=s_dims, a_dims=a_dims, nb_rlouts=nb_rlouts,
                                     buf_size=buf_size, a_min=a_min, a_max=a_max, seed=seed)
        agent.init()
        for _ in range(buf_size):
            states = rng.uniform(size=(1, s_dims)).astype(np.float32)
            agent.record(states, rng.uniform(a_min, a_max, (1, a_dims)).astype(np.float32),
                         rng.normal(size=1), np.zeros(1), states)
        agent.finalize_rlout(np.asarray([0.3]))
        agent.finalize_rlout(np.asarray([0.5]))
        for _ in range(nb_updates):
            agent.train()
        agent.init_rlout()
        agent.save_search(path, extras=extras)
    return agent


@pytest.fixture(scope='module')
def jax_search(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('jax') / 'ddpg_search.npz')
    return write_jax_search(path, S_DIMS, A_DIMS, 10, BUF, extras={'idx_rlout': 4}), path


def _restored(path):
    agent = tagent_lib.DdpgAgent(s_dims=S_DIMS, a_dims=A_DIMS, nb_rlouts=10, buf_size=BUF,
                                 seed=0, device='cpu')
    assert agent.restore_search(path)
    return agent


def _equal(module, tree):
    want = ddpg_state_dict_from_jax(_np(tree))
    got = {k: v.detach() for k, v in module.state_dict().items()} if hasattr(
        module, 'state_dict') else module
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)


def test_restore_equals_the_jax_state(jax_search):
    jagent, path = jax_search
    agent = _restored(path)
    state = jagent.state
    for name in ('actor', 'critic', 'actor_tr', 'critic_tr'):
        _equal(getattr(agent, name), getattr(state, name))
    _equal(agent.actor_perturbed, state.actor_perturbed)
    for opt, net in (('opt_actor', agent.actor), ('opt_critic', agent.critic)):
        adam = _np(getattr(state, opt)[0])
        assert int(adam.count) == 3
        optimizer = getattr(agent, opt)
        mu, nu = ddpg_state_dict_from_jax(adam.mu), ddpg_state_dict_from_jax(adam.nu)
        for name, p in net.named_parameters():
            entry = optimizer.state[p]
            assert float(entry['step']) == float(adam.count)
            np.testing.assert_array_equal(entry['exp_avg'].numpy(), mu[name].numpy())
            np.testing.assert_array_equal(entry['exp_avg_sq'].numpy(), nu[name].numpy())
    for key in ('states', 'actions', 'rewards', 'terminals', 'states_next'):
        np.testing.assert_array_equal(getattr(agent.memory, key), getattr(jagent.memory, key))
    assert (agent.memory.head, agent.memory.count) == (jagent.memory.head, jagent.memory.count)
    assert agent.reward_ema == jagent.reward_ema and agent.reward_ema is not None
    assert agent.noise_spec.stdev_curr == jagent.noise_spec.stdev_curr
    assert agent.in_explore is False and jagent.in_explore is False
    assert int(agent.restored_extras['idx_rlout']) == 4
    # the noise generator restarts from the agent's seed
    fresh = torch.Generator().manual_seed(agent.seed + 1)
    assert torch.equal(agent.noise.get_state(), fresh.get_state())


def test_restored_agent_acts_and_updates_as_jax(jax_search):
    jagent, path = jax_search
    agent = _restored(path)
    probe = _states(np.random.default_rng(7), 8)
    np.testing.assert_allclose(agent.actions_clean(probe), jagent.actions_clean(probe),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(agent.actions_noisy(probe), jagent.actions_noisy(probe),
                               rtol=1e-6, atol=1e-6)
    batch = _minibatch(np.random.default_rng(13))
    got = _port_record(agent, *agent._train(batch))
    after, actor_loss, critic_loss, _ = jagent._train(jagent.state, batch)
    want = _jax_record(after, actor_loss, critic_loss)
    assert set(got) == set(want)
    assert not _failures(got, want)


# ---------------------------------------------------------------------------
# the three searches
# ---------------------------------------------------------------------------

@pytest.fixture
def restores(monkeypatch):
    """Each search's first restore finds a JAX file with its agent's sizes at
    its path (written then); records (success, clean actions of the restored
    agent, JAX's) on fixed states."""
    orig = tagent_lib.DdpgAgent.restore_search
    out = []

    def spy(self, path):
        npz = path if path.endswith('.npz') else path + '.npz'
        if not os.path.exists(npz):
            jagent = write_jax_search(npz, self.s_dims, self.a_dims, self.nb_rlouts,
                                      self.buf_size, self.a_min, self.a_max,
                                      extras={'idx_rlout': RESUME_AT}, seed=self.seed)
        ok = orig(self, path)
        probe = np.random.default_rng(3).uniform(size=(4, self.s_dims)).astype(np.float32)
        out.append((ok, self.actions_clean(probe), jagent.actions_clean(probe)))
        return ok

    monkeypatch.setattr(tagent_lib.DdpgAgent, 'restore_search', spy)
    return out


def _assert_resumed(restores, search_file):
    assert len(restores) == 1
    ok, got, want = restores[0]
    assert ok
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert int(np.load(search_file)['x_idx_rlout']) == NB_RLOUTS - 1
    assert np.load(search_file)['state'][:2].tobytes() == b'PK'  # the port's own file now


def test_amc_search_resumes_a_jax_search_with_its_agent(tmp_path, restores):
    from test_torch_channel_pruning import SEARCH, _port_learner
    learner = _port_learner(tmp_path, **dict(SEARCH, cp_nb_rlouts=NB_RLOUTS))
    state, _, _ = learner.init_state()
    learner._setup_pruner(state)
    learner.search_ratios_rl(state)
    _assert_resumed(restores, tmp_path / 'cp' / 'ddpg_search.npz')
    assert len(learner.rollout_times) == NB_RLOUTS - RESUME_AT - 1


def test_bit_search_resumes_a_jax_search_with_its_agent(tmp_path, restores):
    from pocketflow_tpu_torch.learners.uniform_quantization.bit_optimizer import BitOptimizer
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    from test_torch_bit_optimizer import SMALL, _recorded_bits
    TFLAGS.override(**SMALL, uql_enbl_rl_agent=True, uql_nb_rlouts=NB_RLOUTS,
                    uql_enbl_rl_global_tune=False, uql_quantize_all_layers=True,
                    save_path=str(tmp_path / 'models' / 'model.ckpt'),
                    log_dir=str(tmp_path / 'logs'),
                    uql_tune_save_path=str(tmp_path / 'rl' / 'model.ckpt'))
    learner = UniformQuantLearner(None, ModelHelper(), device='cpu')
    state = learner.init_state_quant()[0]
    seen = _recorded_bits(learner)
    BitOptimizer(learner, state).run()
    _assert_resumed(restores, tmp_path / 'rl' / 'ddpg_search_uql.npz')
    assert len(seen) == NB_RLOUTS - RESUME_AT - 1


def test_ws_search_resumes_a_jax_search_with_its_agent(tmp_path, restores):
    from pocketflow_tpu_torch.learners.weight_sparsification.pr_optimizer import PROptimizer
    from test_torch_weight_sparse import SEARCH, _port_learner
    learner = _port_learner(tmp_path, **dict(SEARCH, ws_nb_rlouts=NB_RLOUTS))
    model = learner.init_state()[0].model
    pairs = PROptimizer(learner).run(model)
    _assert_resumed(restores, tmp_path / 'ws' / 'ddpg_search.npz')
    assert len(pairs) == 4
