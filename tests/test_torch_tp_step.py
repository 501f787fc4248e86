"""Tensor-parallel train steps: gloo CPU ranks of the port against the JAX
package on a pinned 2-D mesh of its virtual devices, from one bridged state,
on one global batch of 16.

Cases: ConvNet @ FMNIST, full-prec and uniform (4-bit weights, every layer
quantized), each at data:1,model:2 (two ranks, batch 16 a rank) and
data:2,model:2 (four ranks, batch 8 a rank), and uniform-tf (per-channel
8-bit weights, 16-bit activations against EMA ranges that clip, in the
quantized regime: step 1 of --uqtf_quant_delay=1) at data:2,model:2, with
--enbl_tensor_parallel.
The JAX rule shards fc3's kernel (3,136 x 1,024) along its output axis;
the port's ranks hold its 512 columns each, with their momentum, and run
fc3 column-parallel (nn/layers.py).  The full state after the step (the
shards gathered) is held to the JAX TP step's by tests/torch_step_parity.py's
bound (rtol 1e-4, atol 1e-5 plus 2x the spread of JAX reruns: the images
and the parameters perturbed by 1e-7 relative, the batch reversed, and the
JAX package's own data-parallel step at the same global batch, whose sums
run in another order); the loss likewise.  Every replicated parameter and
buffer is bit-identical across the model ranks (across every rank).  The
collectives of a step are counted: one gather and one input-gradient sum on
the model group for fc3, and for uniform one MAX of the weights' ranges.
The weight decay's squares of the shards are summed over the model group
(one more all-reduce), so the loss is the full model's.  Every rank is
joined with a 120 s timeout.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.core import mesh as mesh_lib
from pocketflow_tpu_torch.tools import launch
from torch_step_parity import flat_state, jax_runs, moved_past_bound, out_of_bound

torch.set_num_threads(2)
TESTS = os.path.dirname(os.path.abspath(__file__))
GLOBAL_BATCH = 16
BASE = dict(batch_size_eval=8, nb_smpls_train=64, nb_smpls_eval=16, compute_dtype='float32',
            synthetic_data=True, rand_seed=0)
FLAGS_OF = {
    # ConvNet's rate is lrn_rate_init * batch / 128: 0.2, so that fc3 (the
    # shard) moves past its bound in one step
    'full-prec': dict(BASE, lrn_rate_init=1.6),
    # the QAT rate is 1e-3 * lrn_rate_init * batch / 128
    'uniform': dict(BASE, uql_weight_bits=4, uql_quantize_all_layers=True,
                    lrn_rate_init=1600.0),
    'uniform-tf': dict(BASE, lrn_rate_init=1600.0, uqtf_ema_decay=0.9,
                       uqtf_activation_bits=16, uqtf_quant_delay=1),
    'non-uniform': dict(BASE, lrn_rate_init=1600.0, loss_w_dcy=0.05, nuql_weight_bits=4,
                        nuql_init_style='kmeans', nuql_activation_bits=32, nuql_opt_mode='both'),
}
START = {'full-prec': 0, 'uniform': 0, 'uniform-tf': 1, 'non-uniform': 0}
WITH_EXTRA = ('uniform-tf', 'non-uniform')  # the extra is compared; the loss is not
# The JAX package's non-uniform learner does not run under tensor
# parallelism: its optimizer state over (parameters, codebooks) meets a
# sharding tree of another structure at pjit
# (tests/test_tensor_parallel.py::test_tp_training_learners_train[non-uniform],
# marked slow, fails so).  Its data-parallel step at the same global batch is
# the reference: tensor parallelism changes the layout, not the function.
REFERENCE_DP = ('non-uniform',)
# the model group's collectives of a step: fc3's output gathered and its
# input's gradient summed, the weight decay's squares of the shards summed;
# uniform: the weights' ranges (one MAX); non-uniform: fc3's kernel gathered
# for its codebook and the codebook's gradient summed
MODEL_COLLECTIVES = {
    'full-prec': {'all_gather_model': 1, 'all_reduce_sum_model': 2},
    'uniform': {'all_gather_model': 1, 'all_reduce_sum_model': 2, 'all_reduce_max_model': 1},
    'uniform-tf': {'all_gather_model': 1, 'all_reduce_sum_model': 2},
    'non-uniform': {'all_gather_model': 2, 'all_reduce_sum_model': 3},
}
# uniform-tf's case runs in tests/test_torch_tp_step_uniform_tf.py (a worker of its own)
CASES = [('full-prec', (1, 2)), ('full-prec', (2, 2)), ('uniform', (1, 2)), ('uniform', (2, 2))]


def _set_mesh(data, model):
    names, sizes = ((mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS), (data, model)) if model > 1 \
        else ((mesh_lib.DATA_AXIS,), (data,))
    mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:data * model], names, sizes))


def _jax_learner(kind, flags):
    from pocketflow_tpu.nets.convnet_at_fmnist import ModelHelper
    with JFLAGS.scope(**flags):
        helper = ModelHelper()
        if kind == 'uniform-tf':
            from pocketflow_tpu.learners.uniform_quantization_tf.learner import (
                UniformQuantTFLearner)
            learner = UniformQuantTFLearner(None, helper)
            state, tx, _ = learner.init_state_quant()
            step = learner.build_qat_train_step(tx, False)
        elif kind == 'non-uniform':
            from pocketflow_tpu.learners.nonuniform_quantization.learner import (
                NonUniformQuantLearner)
            learner = NonUniformQuantLearner(None, helper)
            state, tx, _ = learner.init_state_quant()
            step = learner.build_quant_train_step(tx)
        elif kind == 'full-prec':
            from pocketflow_tpu.learners.full_precision import FullPrecLearner
            learner = FullPrecLearner(None, helper, enbl_dst=False)
            state, tx, _ = learner.init_state()
            policy_fn = None
        else:
            from pocketflow_tpu.learners.uniform_quantization.learner import (
                UniformQuantLearner)
            learner = UniformQuantLearner(None, helper)
            state, tx, _ = learner.init_state_quant()
            policy_fn = learner._policy_fn()
        if kind not in WITH_EXTRA:
            step = learner.build_train_step(
                tx, policy_fn=policy_fn, loss_extra_fn=lambda s, o, i, l: (
                    0.0, {'ce': helper.softmax_cross_entropy(l, o)}))
    cls = type(learner.dataset_train)
    learner.dataset_train.augment_xy = lambda batch, rng, is_train: cls.augment_xy(
        learner.dataset_train, batch, rng, False)
    return learner, state, step


def _jax_step(kind, flags, learner, template, step):
    helper = learner.model_helper
    extra = jax.tree_util.tree_map(np.array, jax.device_get(template.extra))  # the step donates

    def run(snapshot, images, labels):
        state = template.replace(
            step=jnp.asarray(START[kind], jnp.int32),
            params=jax.tree_util.tree_map(jnp.asarray, snapshot['params']),
            batch_stats=jax.tree_util.tree_map(jnp.asarray, snapshot['batch_stats']),
            opt_state=jax.tree_util.tree_map(jnp.asarray, snapshot['opt_state']),
            extra=jax.tree_util.tree_map(jnp.asarray, snapshot.get('extra', extra)))
        with JFLAGS.scope(**flags):
            state, metrics = step(state, {'image': jnp.asarray(images),
                                          'label': jnp.asarray(labels)}, jax.random.PRNGKey(0))
        if kind in WITH_EXTRA:  # its ranges or codebooks; the loss is not compared
            kept = {k: v for k, v in state.extra.items() if k != 'w_bits'}
            return flat_state(*jax.tree_util.tree_map(np.array, jax.device_get(
                (state.params, state.batch_stats, kept))))
        out = flat_state(*jax.tree_util.tree_map(np.array, jax.device_get(
            (state.params, state.batch_stats, {}))))
        wd = float(helper.weight_decay_loss(snapshot['params']))
        out['loss'] = np.asarray(float(metrics['ce']) + wd)
        return out
    return run


def _setup(kind, data, model):
    """The JAX side: the snapshot (drawn at one device), the global batch,
    the JAX TP step's state and its reruns' (with the JAX DP step)."""
    flags = FLAGS_OF[kind]
    try:
        _set_mesh(1, 1)
        learner, state, _ = _jax_learner(kind, dict(flags, batch_size=GLOBAL_BATCH))
        snapshot = jax.tree_util.tree_map(np.array, jax.device_get(
            {'params': state.params, 'batch_stats': state.batch_stats,
             'opt_state': state.opt_state}))
        if kind == 'uniform-tf':  # ranges that clip some activations
            nb = len(state.extra['act_max'])
            snapshot['extra'] = {'act_min': np.zeros(nb, np.float32),
                                 'act_max': np.random.default_rng(3).uniform(
                                     1.5, 4.0, nb).astype(np.float32)}
        if kind == 'non-uniform':
            snapshot['extra'] = jax.tree_util.tree_map(np.array, jax.device_get(
                {k: v for k, v in state.extra.items() if k != 'w_bits'}))
        with JFLAGS.scope(**flags):
            images, labels = learner.dataset_train.synthesize_arrays(64)
        images, labels = images[:GLOBAL_BATCH], labels[:GLOBAL_BATCH]
        local = dict(flags, batch_size=GLOBAL_BATCH // data)
        if kind in REFERENCE_DP:
            _set_mesh(data, 1)
            learner, template, step = _jax_learner(kind, local)
            assert learner.global_batch_size == GLOBAL_BATCH
            want, reruns = jax_runs(_jax_step(kind, local, learner, template, step), snapshot,
                                    images, labels)
        else:
            _set_mesh(data, model)
            tp_flags = dict(local, enbl_tensor_parallel=True)
            learner, template, step = _jax_learner(kind, tp_flags)
            assert learner.enbl_tp and learner.global_batch_size == GLOBAL_BATCH
            want, reruns = jax_runs(_jax_step(kind, tp_flags, learner, template, step),
                                    snapshot, images, labels)
            _set_mesh(data, 1)  # the JAX package's own data-parallel step
            learner, template, step = _jax_learner(kind, local)
            reruns.append(_jax_step(kind, local, learner, template, step)(snapshot, images,
                                                                          labels))
    finally:
        mesh_lib.reset_global_mesh()
    return dict(flags=dict(local, mesh_shape='data:%d,model:%d' % (data, model),
                           enbl_tensor_parallel=True),
                snapshot={k: snapshot[k] for k in ('params', 'batch_stats', 'extra')
                          if k in snapshot},
                start=flat_state(snapshot['params'], snapshot['batch_stats'],
                                 snapshot.get('extra', {})),
                images=images, labels=labels, want=want, reruns=reruns)


def run_case(case, tmp_path_factory):
    """The JAX side and the port's ranks of one (kind, (data, model))."""
    kind, (data, model) = case
    env = _setup(kind, data, model)
    env.update(kind=kind, data=data, model=model)
    env['ranks'] = launch.spawn(
        'torch_dist_ranks:tp_step', data * model,
        {'kind': kind, 'flags': env['flags'], 'snapshot': env['snapshot'],
         'images': env['images'], 'labels': env['labels'], 'start_step': START[kind]},
        work_dir=str(tmp_path_factory.mktemp('ranks')), paths=[TESTS])
    return env


@pytest.fixture(scope='module', params=CASES, ids=['%s-data%d-model%d' % (k, d, m)
                                                    for k, (d, m) in CASES])
def tp_case(request, tmp_path_factory):
    return run_case(request.param, tmp_path_factory)


def test_tp_step_matches_jax_tp_step(tp_case):
    for rank, out in enumerate(tp_case['ranks']):
        assert out['place'] == (rank // tp_case['model'], rank % tp_case['model'],
                                tp_case['data'], tp_case['model'])
        assert out['global_batch'] == GLOBAL_BATCH
        assert out['bridged']  # bridge.to_jax_numpy gathers fc3's full kernel
        got = dict(out['state'])
        if 'loss' in tp_case['want']:
            got['loss'] = np.asarray(out['loss'])
        assert out_of_bound(tp_case['want'], tp_case['reruns'], got) == []
    # the step moves most tensors past their bound, fc3's sharded kernel
    # among them, so a wrong update shows
    assert moved_past_bound(tp_case['start'], tp_case['want'], tp_case['reruns']) > 0.5
    fc3 = 'fc3/kernel'
    assert moved_past_bound({fc3: tp_case['start'][fc3]}, {fc3: tp_case['want'][fc3]},
                            [{fc3: r[fc3]} for r in tp_case['reruns']]) == 1.0


def test_shards_follow_the_jax_rule(tp_case):
    """fc3's kernel (the one leaf of ConvNet the JAX rule shards: 3,136 x
    1,024) and its momentum hold 512 columns a rank; nothing else is
    sharded."""
    width = 1024 // tp_case['model']
    for out in tp_case['ranks']:
        assert out['shards'] == {'fc3.kernel': (3136, width)}
        assert out['momentum'] == {'fc3.kernel': (3136, width)}


def test_replicated_leaves_are_bit_identical_across_model_ranks(tp_case):
    """Every replicated parameter and buffer, and the gathered state, equal
    bit for bit on every rank (on the model ranks of each data group and
    across the data groups)."""
    first = tp_case['ranks'][0]
    for out in tp_case['ranks'][1:]:
        assert out['replicated'].keys() == first['replicated'].keys()
        for key, value in first['replicated'].items():
            assert np.array_equal(out['replicated'][key], value), key
        for key, value in first['state'].items():
            assert np.array_equal(out['state'][key], value), key
        assert out['loss'] == first['loss']


def test_collectives_of_a_tp_step(tp_case):
    """Model group: MODEL_COLLECTIVES (uniform-tf's per-channel ranges are
    the shard's own columns: no collective).  Data group (at data 2): one
    gradient all-reduce of the shards, two a BN, uniform-tf's EMA ranges;
    the world: one gradient all-reduce of the replicated parameters (the
    codebooks among them)."""
    counts = tp_case['ranks'][0]['counts']
    nb_bn = sum(1 for k in tp_case['want'] if k.endswith('/mean'))
    model_kinds = MODEL_COLLECTIVES[tp_case['kind']]
    data_reduces = (1 + 2 * nb_bn) if tp_case['data'] > 1 else 0
    if tp_case['kind'] == 'uniform-tf':  # the EMA ranges over the data group
        data_reduces += 1
    assert counts == {'all_reduce': data_reduces + 1, 'broadcast': 0, 'barrier': 0,
                      **model_kinds}
    launches = tp_case['ranks'][0]['launches']
    assert launches['plain'] == (1 if tp_case['kind'] in ('uniform', 'uniform-tf') else 0)
