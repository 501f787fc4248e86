"""The port's non-uniform codebook quantization (pocketflow_tpu_torch/ops/
nonuniform_quant.py, learners/nonuniform_quantization) against the JAX
package on the CPU:

* nonuniform_quant with no bucket, split buckets (with a padded tail) and
  channel buckets: the forward bit-equal to the JAX op's, the x gradient the
  straight-through g, the codebook gradient within 1e-6 relative of JAX's
  segment_sum;
* init_codebook 'uniform' (bit-equal), 'quantile' (linear interpolation,
  1e-6) and 'kmeans' (25 Lloyd steps from the uniform levels, 1e-5), per
  tensor and per bucket;
* one train step of ResNet-20 @ CIFAR-10 (batch 8, fp32, 4-bit kmeans
  codebooks on the 20 weights between the first and the last layer) from the
  bridged JAX state and codebooks, against JAX's build_quant_train_step in
  each --nuql_opt_mode: parameters, BN statistics and codebooks held to the
  slice bound (tests/torch_step_parity.py); the frozen side bit-unchanged.
  Planted fault: weight decay on the codebooks (--loss_w_dcy 0.05 so that
  it shows) must fail the 'both' step;
* BitOptimizer(prefix='nuql'): with the agent's actions fixed, every
  roll-out's bit list equal to the JAX search's, its checkpoint
  ddpg_search_nuql.npz;
* copy_state with codebooks: a roll-out's copy trains its own codebooks and
  momentum, the baseline state stays bit-unchanged;
* main.main --learner=non-uniform on the CPU (4-bit codebooks, 8-bit
  activations): at most 16 distinct values in each quantized kernel.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.core import mesh as mesh_lib
from pocketflow_tpu.ops import nonuniform_quant as jnuq
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core.bridge import extra_from_jax, load_jax_numpy
from pocketflow_tpu_torch.ops import nonuniform_quant as tnuq
from test_torch_bit_optimizer import _fixed_actions, _recorded_bits
from torch_slice_parity import CIFAR_SMALL, _deterministic_augment
from torch_step_parity import flat_state, jax_runs, moved_past_bound, out_of_bound

torch.set_num_threads(2)
BUCKETS = [(None, 0), ('split', 64), ('channel', 0)]
SHAPE = (3, 3, 16, 23)  # 3,312 weights: 52 split buckets of 64, the last padded by 16
# the quant finetune's rate is 1e-3 * lrn_rate_init * batch / 128: 0.1
NUQ_SMALL = dict(CIFAR_SMALL, lrn_rate_init=1600.0, loss_w_dcy=0.05, nuql_weight_bits=4,
                 nuql_init_style='kmeans', nuql_activation_bits=32)
OPT_MODES = ('weights', 'cluster', 'both')


@pytest.fixture(autouse=True)
def _port_flags():
    import pocketflow_tpu_torch.learners.nonuniform_quantization.learner  # noqa: F401
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _weights_and_codebook(bucket_type, bucket_size, bits=4, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(SHAPE) * 0.05).astype(np.float32)
    nb = {None: 1, 'channel': SHAPE[-1], 'split': -(-x.size // max(1, bucket_size))}[bucket_type]
    c = np.sort(rng.random((2 ** bits, nb)), axis=0).astype(np.float32)
    g = rng.standard_normal(SHAPE).astype(np.float32)
    return x, c, g


@pytest.mark.parametrize('bucket_type,bucket_size', BUCKETS)
def test_nonuniform_quant_matches_jax(bucket_type, bucket_size):
    x, c, g = _weights_and_codebook(bucket_type, bucket_size)
    out, vjp = jax.vjp(lambda xx, cc: jnuq.nonuniform_quant(xx, cc, bucket_type, bucket_size),
                       jnp.asarray(x), jnp.asarray(c))
    jdx, jdc = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tc = torch.from_numpy(c).requires_grad_(True)
    got = tnuq.nonuniform_quant(tx, tc, bucket_type, bucket_size)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(tx.grad.numpy(), g)  # the straight-through estimator
    np.testing.assert_array_equal(np.asarray(jdx), g)
    want = np.asarray(jdc)
    assert np.linalg.norm(tc.grad.numpy() - want) <= 1e-6 * np.linalg.norm(want)
    # every weight on one of its bucket's levels
    per_column = bucket_type is not None
    levels = np.unique(got.detach().numpy()).size
    assert levels <= 16 * c.shape[1] and (per_column or levels <= 16)


@pytest.mark.parametrize('bucket_type,bucket_size', BUCKETS)
@pytest.mark.parametrize('style', ['uniform', 'quantile', 'kmeans'])
def test_init_codebook_matches_jax(style, bucket_type, bucket_size):
    x, _, _ = _weights_and_codebook(bucket_type, bucket_size)
    want = np.asarray(jnuq.init_codebook(jnp.asarray(x), 4, style, bucket_type, bucket_size))
    got = tnuq.init_codebook(torch.from_numpy(x), 4, style, bucket_type, bucket_size).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if style == 'uniform':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol={'quantile': 1e-6, 'kmeans': 1e-5}[style],
                                   atol=1e-7)


def test_unknown_init_style_and_bucket_type_raise():
    x = torch.zeros(SHAPE)
    with pytest.raises(ValueError):
        tnuq.init_codebook(x, 4, 'no-such-style', None, 0)
    with pytest.raises(ValueError):
        tnuq.to_buckets(x, 'no-such-bucket', 0)


@pytest.fixture(scope='module')
def learners():
    """The JAX and port non-uniform learners on ResNet-20 @ CIFAR-10, the
    JAX initial state (codebooks from its weights) and one batch."""
    from pocketflow_tpu.learners.nonuniform_quantization.learner import (
        NonUniformQuantLearner as JLearner)
    from pocketflow_tpu.nets.resnet_at_cifar10 import ModelHelper as JHelper
    from pocketflow_tpu_torch.learners.nonuniform_quantization.learner import (
        NonUniformQuantLearner as TLearner)
    from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper as THelper
    mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:1], ('data',), (1,)))
    with JFLAGS.scope(**NUQ_SMALL), TFLAGS.scope(**NUQ_SMALL):
        jlearner = JLearner(None, JHelper())
        tlearner = TLearner(None, THelper(), device='cpu')
        jstate, jtx, _ = jlearner.init_state_quant()
    for lrn in (jlearner, tlearner):
        _deterministic_augment(lrn.dataset_train)
    snapshot = jax.tree_util.tree_map(np.array, jax.device_get(
        {'params': jstate.params, 'batch_stats': jstate.batch_stats,
         'opt_state': jstate.opt_state, 'extra': jstate.extra}))
    images, labels = jlearner.dataset_train.synthesize_arrays(64)
    yield dict(jlearner=jlearner, tlearner=tlearner, jstate=jstate, jtx=jtx,
               snapshot=snapshot, images=images[:8], labels=labels[:8])
    mesh_lib.reset_global_mesh()


def _jax_step(env, opt_mode):
    with JFLAGS.scope(**NUQ_SMALL, nuql_opt_mode=opt_mode):
        step = env['jlearner'].build_quant_train_step(env['jtx'])

    def run(snapshot, images, labels):
        state = env['jstate'].replace(
            step=jnp.asarray(0, jnp.int32),
            params=jax.tree_util.tree_map(jnp.asarray, snapshot['params']),
            batch_stats=jax.tree_util.tree_map(jnp.asarray, snapshot['batch_stats']),
            opt_state=jax.tree_util.tree_map(jnp.asarray, snapshot['opt_state']),
            extra=jax.tree_util.tree_map(jnp.asarray, snapshot['extra']))
        with JFLAGS.scope(**NUQ_SMALL):  # the policy reads the bucket flags when it traces
            state, _ = step(state, {'image': jnp.asarray(images),
                                    'label': jnp.asarray(labels)}, jax.random.PRNGKey(0))
        return flat_state(*jax.tree_util.tree_map(np.array, jax.device_get(
            (state.params, state.batch_stats, state.extra))))
    return run


def _port_step(env, opt_mode, calc_loss=None):
    """The port's step from the snapshot (its codebooks bridged, a fresh
    optimizer over parameters and codebooks): the flat state after it."""
    tlearner = env['tlearner']
    snapshot = env['snapshot']
    with TFLAGS.scope(**NUQ_SMALL, nuql_opt_mode=opt_mode):
        state, tx, _ = tlearner.init_state_quant()
        load_jax_numpy(state.model, snapshot['params'], snapshot['batch_stats'])
        state.extra = extra_from_jax(snapshot['extra'])
        state.optimizer = tx.init(state.model, list(state.extra['codebooks'].values()))
        step = tlearner.build_quant_train_step(tx)
        helper = tlearner.model_helper
        if calc_loss is not None:
            helper.calc_loss = lambda *args: calc_loss(helper, state, *args)
        try:
            state, _ = step(state, tlearner.put_batch(
                {'image': env['images'], 'label': env['labels']}), None)
        finally:
            helper.__dict__.pop('calc_loss', None)
    extra = {'codebooks': {p: c.detach().numpy() for p, c in state.extra['codebooks'].items()},
             'a_bits': state.extra['a_bits'].numpy()}
    return flat_state({k: v.detach().numpy() for k, v in state.params.items()},
                      {k: v.numpy() for k, v in state.batch_stats.items()}, extra)


@pytest.fixture(scope='module')
def jax_steps(learners):
    return {mode: jax_runs(_jax_step(learners, mode), learners['snapshot'], learners['images'],
                           learners['labels']) for mode in OPT_MODES}


@pytest.mark.parametrize('opt_mode', OPT_MODES)
def test_step_matches_jax(learners, jax_steps, opt_mode):
    want, reruns = jax_steps[opt_mode]
    got = _port_step(learners, opt_mode)
    assert out_of_bound(want, reruns, got) == []
    snapshot = learners['snapshot']
    start = flat_state(snapshot['params'], snapshot['batch_stats'], snapshot['extra'])
    books = [k for k in want if k.startswith('extra/codebooks/')]
    kernels = [k for k in want if k.endswith('/kernel')]
    assert len(books) == 20 and len(kernels) == 22
    frozen = {'weights': books, 'cluster': kernels, 'both': []}[opt_mode]
    assert all(np.array_equal(got[k], start[k]) for k in frozen)
    trained = [k for k in books + kernels if k not in frozen]
    # a wrong update would show: the trained tensors move past their bound
    # (measured: all of them)
    assert moved_past_bound(start, {k: want[k] for k in trained}, reruns) >= 0.9


def test_weight_decay_on_codebooks_fails(learners, jax_steps):
    """Planted fault: the codebooks take the weight decay, as if kernels."""
    def calc_loss(helper, state, labels, outputs, params):
        loss, metrics = type(helper).calc_loss(helper, labels, outputs, params)
        books = ((p + '/codebook/kernel', c) for p, c in state.extra['codebooks'].items())
        return loss + helper.weight_decay_loss(books), metrics

    want, reruns = jax_steps['both']
    bad = {key for key, _, _ in out_of_bound(want, reruns, _port_step(learners, 'both',
                                                                       calc_loss))}
    assert bad and all(key.startswith('extra/codebooks/') for key in bad)


@pytest.mark.parametrize('random_layers', [True, False])
def test_bit_search_lists_match_jax_with_fixed_actions(tmp_path, monkeypatch, random_layers):
    from pocketflow_tpu.learners.nonuniform_quantization.learner import (
        NonUniformQuantLearner as JL)
    from pocketflow_tpu.learners.uniform_quantization.bit_optimizer import BitOptimizer as JBO
    from pocketflow_tpu.nets.convnet_at_fmnist import ModelHelper as JHelper
    from pocketflow_tpu.rl_agents.ddpg.agent import DdpgAgent as JAgent
    from pocketflow_tpu_torch.learners.nonuniform_quantization.learner import (
        NonUniformQuantLearner)
    from pocketflow_tpu_torch.learners.uniform_quantization.bit_optimizer import BitOptimizer
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    from pocketflow_tpu_torch.rl_agents.ddpg.agent import DdpgAgent
    flags = dict(batch_size=8, batch_size_eval=8, nb_smpls_train=64, nb_smpls_eval=16,
                 nb_smpls_val=8, compute_dtype='float32', synthetic_data=True, rand_seed=0,
                 nuql_enbl_rl_agent=True, nuql_nb_rlouts=4, nuql_enbl_rl_global_tune=False,
                 nuql_enbl_random_layers=random_layers, nuql_quantize_all_layers=True,
                 nuql_equivalent_bits=4, nuql_init_style='uniform',
                 # the uniform learner's flags differ, so a search reading them fails
                 uql_nb_rlouts=7, uql_equivalent_bits=8)
    bits = {}
    mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:1], ('data',), (1,)))
    try:
        for name, learner_cls, helper, bo, agent in (
                ('jax', JL, JHelper, JBO, JAgent),
                ('port', NonUniformQuantLearner, ModelHelper, BitOptimizer, DdpgAgent)):
            registry = JFLAGS if name == 'jax' else TFLAGS
            _fixed_actions(monkeypatch, agent, seed=3)
            with registry.scope(**flags, nuql_tune_save_path=str(tmp_path / name / 'rl' / 'm')):
                learner = (learner_cls(None, helper()) if name == 'jax'
                           else learner_cls(None, helper(), device='cpu'))
                state = learner.init_state_quant()[0]
                seen = _recorded_bits(learner)
                best, a_bits = bo(learner, state, prefix='nuql').run()
                bits[name] = (seen, best, learner.statistics['num_weights'], a_bits)
    finally:
        mesh_lib.reset_global_mesh()
    seen, best, num_weights, a_bits = bits['port']
    assert seen == bits['jax'][0] and len(seen) == 4 and best in seen
    assert any(len(set(b)) > 1 for b in seen) and a_bits == [32] * len(a_bits)
    for w_bits in seen:
        assert np.dot(w_bits, num_weights) <= 4 * sum(num_weights)
    assert (tmp_path / 'port' / 'rl' / 'ddpg_search_nuql.npz').exists()


def _small_learner(tmp_path):
    from pocketflow_tpu_torch.learners.nonuniform_quantization.learner import (
        NonUniformQuantLearner)
    from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper
    TFLAGS.override(**NUQ_SMALL, nuql_opt_mode='both',
                    save_path=str(tmp_path / 'models' / 'model.ckpt'))
    return NonUniformQuantLearner(None, ModelHelper(), device='cpu')


def test_copy_state_with_codebooks_isolates_a_rollout(tmp_path):
    learner = _small_learner(tmp_path)
    baseline, tx, _ = learner.init_state_quant()
    step = learner.build_quant_train_step(tx)
    batch = learner.put_batch(next(learner.dataset_train.build()))
    step(baseline, batch, None)  # momentum buffers for the codebooks to copy

    def tensors(state):
        books = list(state.extra['codebooks'].values())
        momenta = [state.optimizer.state[p]['momentum_buffer']
                   for group in state.optimizer.param_groups for p in group['params']]
        return list(state.model.parameters()) + list(state.model.buffers()) + books + momenta

    before = [t.detach().clone() for t in tensors(baseline)]
    copy = learner.copy_state(baseline)
    assert [len(g['params']) for g in copy.optimizer.param_groups] == [
        len(g['params']) for g in baseline.optimizer.param_groups] == [len(list(
            baseline.model.parameters())), 20]
    books = copy.optimizer.param_groups[1]['params']
    assert all(a is b for a, b in zip(books, copy.extra['codebooks'].values()))
    assert not {t.data_ptr() for t in tensors(copy)} & {t.data_ptr() for t in tensors(baseline)}
    for _ in range(2):
        copy, _ = step(copy, batch, None)
    assert not all(torch.equal(a, b) for a, b in zip(
        copy.extra['codebooks'].values(), baseline.extra['codebooks'].values()))
    assert all(torch.equal(a, b) for a, b in zip(tensors(baseline), before))
    # a roll-out at mixed bits rebuilds a copy's codebooks and optimizer
    mixed = learner.set_bits(learner.copy_state(baseline), [(2, 8, 4)[i % 3] for i in range(20)],
                             [32] * 19)
    assert [c.shape[0] for c in mixed.extra['codebooks'].values()] == [
        2 ** (2, 8, 4)[i % 3] for i in range(20)]
    assert all(torch.equal(a, b) for a, b in zip(tensors(baseline), before))


def test_main_runs_non_uniform_on_cpu(tmp_path, monkeypatch):
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.core import checkpoint as ckpt
    from pocketflow_tpu_torch.ops import fake_quant as fq
    from pocketflow_tpu_torch.ops import nonuniform_quant as nuq
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    if 'model' in TFLAGS:
        TFLAGS.model = TFLAGS._specs['model'].default
    argv = ['--model=resnet_at_cifar10', '--synthetic_data', '--nb_smpls_train=16',
            '--nb_smpls_eval=16', '--batch_size=8', '--batch_size_eval=8',
            '--compute_dtype=float32', '--summ_step=1', '--log_dir=%s' % (tmp_path / 'logs'),
            '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt'),
            '--nuql_save_quant_model_path=%s' % (tmp_path / 'nuql' / 'model.ckpt')]
    port_main.main(argv + ['--nb_epochs_rat=0.004'], device='cpu')  # the baseline: 2 steps
    fq.reset_counters()
    learner = port_main.main(argv + ['--learner=non-uniform', '--nuql_activation_bits=8',
                                     '--nuql_opt_mode=both', '--nuql_quant_epochs=1',
                                     '--nb_epochs_rat=1'], device='cpu')
    payload = ckpt.restore_latest(str(tmp_path / 'nuql' / 'model.ckpt'))
    assert payload['step'] == 2 and len(payload['extra']['codebooks']) == 20
    assert learner.statistics['nb_matmuls'] == 20
    # 19 activations through fake_quant_select (its plain version on the CPU) a forward
    assert fq.counters()['plain'] > 0 and fq.counters()['plain'] % 19 == 0
    model = payload['model']
    for path, c in payload['extra']['codebooks'].items():
        q = nuq.nonuniform_quant(model[path.replace('/', '.') + '.kernel'], c, None, 0)
        assert c.shape == (16, 1) and torch.unique(q).numel() <= 16
