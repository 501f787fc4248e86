"""The port's RL bit search (pocketflow_tpu_torch/learners/uniform_quantization/
bit_optimizer.py), copy_state and the mixed-bit forward, against the JAX
package on the CPU.

* with the agent's actions fixed (the same numpy draws in both packages),
  every roll-out's bit list equals the JAX BitOptimizer's, with the layers
  visited in order and in a random order, and stays under the bit budget;
* ResNet-20's eval forward with mixed per-layer bits (2-8, through the
  grouped fake-quant's plain version): each quantized weight bit-equal to the
  JAX QuantPolicy's, logits within 1e-3 (test_torch_zoo.py's bound);
* copy_state: a roll-out's copy shares no tensor with the baseline, and its
  quantized forward is unchanged when the baseline's weights move after the
  copy (the learner's policy looks its weights up per model);
* main.main with --learner=uniform --uql_enbl_rl_agent on the CPU;
* bits_state names its device.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.core import mesh as mesh_lib
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from test_torch_zoo import _apply_with, _setup, _sites

torch.set_num_threads(2)
SMALL = dict(batch_size=8, batch_size_eval=8, nb_smpls_train=64, nb_smpls_eval=16,
             nb_smpls_val=8, compute_dtype='float32', synthetic_data=True, rand_seed=0)


@pytest.fixture(autouse=True)
def _port_flags(monkeypatch):
    import pocketflow_tpu_torch.learners.uniform_quantization.learner  # noqa: F401  (uql_* flags)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _fixed_actions(monkeypatch, agent_cls, seed):
    """agent_cls.actions_noisy returns draws of one numpy stream in [0, 6]."""
    rng = np.random.default_rng(seed)
    monkeypatch.setattr(agent_cls, 'actions_noisy',
                        lambda self, states: rng.uniform(0.0, 6.0, (1, 1)).astype(np.float32))


def _recorded_bits(learner):
    """Record every bit list a roll-out sets on the learner."""
    seen, set_bits = [], learner.set_bits

    def recording(state, w_bits, a_bits):
        seen.append(list(w_bits))
        return set_bits(state, w_bits, a_bits)

    learner.set_bits = recording
    return seen


@pytest.mark.parametrize('random_layers', [True, False])
def test_bit_lists_match_jax_with_fixed_actions(tmp_path, monkeypatch, random_layers):
    from pocketflow_tpu.learners.uniform_quantization.bit_optimizer import BitOptimizer as JBO
    from pocketflow_tpu.learners.uniform_quantization.learner import UniformQuantLearner as JL
    from pocketflow_tpu.nets.convnet_at_fmnist import ModelHelper as JHelper
    from pocketflow_tpu.rl_agents.ddpg.agent import DdpgAgent as JAgent
    from pocketflow_tpu_torch.learners.uniform_quantization.bit_optimizer import BitOptimizer
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    from pocketflow_tpu_torch.rl_agents.ddpg.agent import DdpgAgent
    flags = dict(SMALL, uql_enbl_rl_agent=True, uql_nb_rlouts=4, uql_enbl_rl_global_tune=False,
                 uql_enbl_random_layers=random_layers, uql_quantize_all_layers=True,
                 uql_equivalent_bits=4)
    bits = {}
    mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:1], ('data',), (1,)))
    try:
        for name, learner_cls, helper, bo, agent in (
                ('jax', JL, JHelper, JBO, JAgent), ('port', UniformQuantLearner, ModelHelper,
                                                    BitOptimizer, DdpgAgent)):
            registry = JFLAGS if name == 'jax' else TFLAGS
            with registry.scope(**flags, uql_tune_save_path=str(tmp_path / name / 'rl' / 'm')):
                _fixed_actions(monkeypatch, agent, seed=3)
                learner = (learner_cls(None, helper()) if name == 'jax'
                           else learner_cls(None, helper(), device='cpu'))
                state = (learner.init_state_quant()[0])
                seen = _recorded_bits(learner)
                best, a_bits = bo(learner, state).run()
                bits[name] = (seen, best, learner.statistics['num_weights'])
    finally:
        mesh_lib.reset_global_mesh()
    seen, _, num_weights = bits['port']
    assert seen == bits['jax'][0] and len(seen) == 4
    assert len({tuple(b) for b in seen}) > 1 and any(len(set(b)) > 1 for b in seen)
    for w_bits in seen:
        assert all(2 <= b <= 8 for b in w_bits)
        assert np.dot(w_bits, num_weights) <= 4 * sum(num_weights)
    assert bits['port'][1] in seen


def test_mixed_bit_forward_matches_jax():
    """ResNet-20, per-layer bits [2, 8, 4, 3, 5, 6, 7, ...] through the
    grouped plain version: quantized weights bit-equal, logits within 1e-3."""
    from pocketflow_tpu.learners.uniform_quantization import utils as juq
    from pocketflow_tpu_torch.learners.uniform_quantization import utils as tuq
    from pocketflow_tpu_torch.nn import layers as tl
    from pocketflow_tpu_torch.ops import fake_quant as fq
    jm, variables, tm, x = _setup('resnet_at_cifar10')
    jsites, _ = _sites('resnet_at_cifar10', jm, variables, tm, x)
    paths = jsites['weight_paths']
    w_bits = np.asarray([(2, 8, 4, 3, 5, 6, 7)[i % 7] for i in range(len(paths))], np.float32)
    a_bits = np.full(jsites['nb_activations'], 32.0, np.float32)
    flags = dict(uql_activation_bits=32, uql_use_buckets=False)
    with JFLAGS.scope(**flags), TFLAGS.scope(**flags):
        jpolicy = juq.QuantPolicy(paths, jnp.asarray(w_bits), jnp.asarray(a_bits))
        tpolicy = tuq.QuantPolicy(paths, torch.from_numpy(w_bits), torch.from_numpy(a_bits),
                                  tuq.quant_weights(tm, paths))
        kernels = {m.path: m.kernel for m in tm.modules()
                   if isinstance(m, (tl.PFConv, tl.PFDense))}
        flat = {'/'.join(k.key for k in path[:-1]): leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(variables['params'])[0]
                if path[-1].key == 'kernel'}
        tpolicy.reset_trace()
        for path in paths:
            want = np.asarray(jpolicy.process_weight(path, jnp.asarray(flat[path])))
            got = tpolicy.process_weight(path, kernels[path]).detach().numpy()
            np.testing.assert_array_equal(got, want, err_msg=path)
        want = np.asarray(jax.jit(lambda v, xx: _apply_with(jm, v, xx, paths, w_bits, a_bits))(
            variables, jnp.asarray(x)))
        fq.reset_counters()
        with torch.no_grad(), tl.compression(tpolicy):
            got = tm(torch.from_numpy(x)).numpy()
        assert fq.counters()['plain'] == 1  # one grouped call for the 20 weights
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_copy_state_isolates_a_rollout(tmp_path):
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper
    TFLAGS.override(**SMALL, save_path=str(tmp_path / 'models' / 'model.ckpt'))
    learner = UniformQuantLearner(None, ModelHelper(), device='cpu')
    baseline, tx, _ = learner.init_state_quant()
    batch = learner.put_batch(next(learner.dataset_train.build()))
    learner.build_quant_train_step(tx)(baseline, batch, None)  # momentum buffers to copy
    copy = learner.set_bits(learner.copy_state(baseline), [(2, 8, 4, 3)[i % 4] for i in range(20)],
                            [32] * 19)
    tensors = lambda s: (list(s.model.parameters()) + list(s.model.buffers())  # noqa: E731
                         + [b['momentum_buffer'] for b in s.optimizer.state.values()])
    assert len(tensors(copy)) == len(tensors(baseline))
    assert not {t.data_ptr() for t in tensors(copy)} & {t.data_ptr() for t in tensors(baseline)}
    policy_fn = learner._policy_fn()
    images = learner.dataset_eval.augment(batch['image'], None, False)

    def logits(state):
        with torch.no_grad():
            return learner.model_helper.forward_eval(state.model, images, policy=policy_fn(state))

    before, base_before = logits(copy), logits(baseline)
    with torch.no_grad():
        for p in baseline.model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    assert not torch.equal(logits(baseline), base_before)
    assert torch.equal(logits(copy), before)


def test_main_runs_the_bit_search(tmp_path):
    """python -m pocketflow_tpu_torch.main --learner=uniform --uql_enbl_rl_agent,
    from a full-prec baseline: two roll-outs (one layerwise-tuned), then the
    finetune at the chosen bits."""
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.core import checkpoint as ckpt
    from pocketflow_tpu_torch.ops import fake_quant as fq
    if 'model' in TFLAGS:
        TFLAGS.model = TFLAGS._specs['model'].default
    argv = ['--synthetic_data', '--nb_smpls_train=32', '--nb_smpls_eval=16', '--batch_size=8',
            '--batch_size_eval=8', '--compute_dtype=float32', '--summ_step=1',
            '--log_dir=%s' % (tmp_path / 'logs'),
            '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt'),
            '--uql_save_quant_model_path=%s' % (tmp_path / 'uql' / 'model.ckpt'),
            '--uql_tune_save_path=%s' % (tmp_path / 'rl' / 'model.ckpt')]
    port_main.main(argv + ['--nb_epochs_rat=0.01'], device='cpu')
    fq.reset_counters()
    learner = port_main.main(argv + [
        '--learner=uniform', '--uql_enbl_rl_agent', '--uql_nb_rlouts=2',
        '--uql_tune_global_steps=2', '--uql_enbl_rl_layerwise_tune', '--uql_tune_layerwise_steps=1',
        '--uql_quantize_all_layers', '--nb_epochs_rat=0.5'], device='cpu')
    bits = learner.optimal_w_bit_list
    num_weights = learner.statistics['num_weights']
    assert len(bits) == 4 and all(2 <= b <= 8 for b in bits)
    assert np.dot(bits, num_weights) <= 4 * sum(num_weights)
    search = np.load(tmp_path / 'rl' / 'ddpg_search_uql.npz')
    assert int(search['x_idx_rlout']) == 1
    payload = ckpt.restore_latest(str(tmp_path / 'uql' / 'model.ckpt'))
    assert payload['extra']['w_bits'].tolist() == bits
    assert fq.counters()['plain'] > 0


def test_bits_state_needs_a_device():
    from pocketflow_tpu_torch.learners.uniform_quantization import utils as uq_utils
    stats = {'nb_matmuls': 3, 'nb_activations': 2}
    with pytest.raises(TypeError):
        uq_utils.bits_state(stats, [4, 4, 4], [32, 32])
    extra = uq_utils.bits_state(stats, [2, 8, 4], None, device='cpu')
    assert extra['w_bits'].tolist() == [2.0, 8.0, 4.0] and extra['a_bits'].shape == (2,)
