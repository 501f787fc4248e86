"""Data-parallel train steps: two gloo CPU ranks of the port against the JAX
package on a pinned 2-device mesh, from one bridged state, on one global
batch of 16 (batch 8 a rank; rank r takes rows 8r..8r+7, the JAX data
shards' rows).

Cases (tests/torch_dist_ranks.py): ResNet-20 @ CIFAR-10 full-prec with
exact sync-BN, and with ghost-BN-2 (each rank's leading 4 samples); ConvNet
@ FMNIST at 8-bit activations in the exact regime of
tests/test_torch_qat_act8_exact.py, with the white block only in rank 0's
rows and rank 1's images dim (1 white pixel in 5), so that rank 1's local
activation ranges fall short of the global ones; MobileNet-v1 @ 64
uniform-tf in the quantized regime (16-bit activations, the EMA from the
global batch's (min, max)); ResNet-20
non-uniform (codebook gradients all-reduced).  Each rank's state after the
step is held to the JAX step's by tests/torch_step_parity.py's bound (rtol
1e-4, atol 1e-5 plus 2x the spread of JAX reruns: the images and the
parameters perturbed by 1e-7 relative, the batch reversed, and the same
step on one device at batch 16, whose sums run in another order (on
ResNet-20 the structural cancellation in the first layers' gradients moves
conv_init's update by 5.9e-3 between the JAX package's own 1- and 2-device
steps); act8: the reversed batch and the 1-device step); the loss, where
the JAX step reports it, likewise.
The ranks end bit-identical, and two ranks at batch 8 equal one port rank
at batch 16 within the same bound whose floor is the JAX package's own
difference between its 2- and 1-device steps: the same function, its sums
in another order.  Every rank is joined with a 120 s timeout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.core import mesh as mesh_lib
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.tools import launch
from test_torch_mobilenet import MOBILENET_SMALL
from test_torch_nonuniform import NUQ_SMALL
from test_torch_qat_act8_exact import FLAGS as ACT8_FLAGS, exact_regime
from test_torch_uniform_tf import UQTF_SMALL
from torch_dist_ranks import CASES, port_step
from torch_slice_parity import CIFAR_RATE, CIFAR_SMALL
from torch_step_parity import flat_state, jax_runs, out_of_bound

torch.set_num_threads(2)
TESTS = __import__('os').path.dirname(__import__('os').path.abspath(__file__))
WORLD = 2
BATCH = 8  # a rank's
FLAGS_OF = {
    'full-prec': dict(CIFAR_SMALL, lrn_rate_init=CIFAR_RATE['full-prec']),
    'ghost-bn': dict(CIFAR_SMALL, lrn_rate_init=CIFAR_RATE['full-prec'], bn_stats_subsample=2),
    'act8': dict(ACT8_FLAGS),
    'uniform-tf': dict(UQTF_SMALL, uqtf_quant_delay=1),
    'non-uniform': dict(NUQ_SMALL, nuql_opt_mode='both'),
}


def _jax_learner(case, flags):
    net, kind, _, _ = CASES[case]
    helper = __import__('importlib').import_module('pocketflow_tpu.nets.' + net).ModelHelper()
    if kind == 'full-prec':
        from pocketflow_tpu.learners.full_precision import FullPrecLearner
        learner = FullPrecLearner(None, helper, enbl_dst=False)
        state, tx, _ = learner.init_state()
    elif kind == 'uniform':
        from pocketflow_tpu.learners.uniform_quantization.learner import UniformQuantLearner
        learner = UniformQuantLearner(None, helper)
        state, tx, _ = learner.init_state_quant()
    elif kind == 'uniform-tf':
        from pocketflow_tpu.learners.uniform_quantization_tf.learner import (
            UniformQuantTFLearner)
        learner = UniformQuantTFLearner(None, helper)
        state, tx, _ = learner.init_state_quant()
    else:
        from pocketflow_tpu.learners.nonuniform_quantization.learner import (
            NonUniformQuantLearner)
        learner = NonUniformQuantLearner(None, helper)
        state, tx, _ = learner.init_state_quant()
    return learner, state, tx


def _jax_step(case, flags, learner, template, tx):
    """jax_step(snapshot, images, labels) -> the flat state after one JAX
    step (with 'loss' where the case compares it)."""
    _, kind, start, with_loss = CASES[case]
    helper = learner.model_helper
    with JFLAGS.scope(**flags):
        if kind in ('full-prec', 'uniform'):
            step = learner.build_train_step(
                tx, policy_fn=learner._policy_fn() if kind == 'uniform' else None,
                loss_extra_fn=lambda s, o, i, l: (0.0, {'ce': helper.softmax_cross_entropy(l, o)}))
        elif kind == 'uniform-tf':
            step = learner.build_qat_train_step(tx, False)
        else:
            step = learner.build_quant_train_step(tx)
    exclude_bn = case != 'act8'

    def run(snapshot, images, labels):
        state = template.replace(
            step=jnp.asarray(start, jnp.int32),
            params=jax.tree_util.tree_map(jnp.asarray, snapshot['params']),
            batch_stats=jax.tree_util.tree_map(jnp.asarray, snapshot['batch_stats']),
            opt_state=jax.tree_util.tree_map(jnp.asarray, snapshot['opt_state']),
            extra=jax.tree_util.tree_map(jnp.asarray, snapshot['extra']))
        with JFLAGS.scope(**flags):
            state, metrics = step(state, {'image': jnp.asarray(images),
                                          'label': jnp.asarray(labels)}, jax.random.PRNGKey(0))
        extra = ({k: v for k, v in jax.device_get(state.extra).items() if k != 'w_bits'}
                 if kind in ('uniform-tf', 'non-uniform') else {})
        out = flat_state(*jax.tree_util.tree_map(np.array, jax.device_get(
            (state.params, state.batch_stats, extra))))
        if with_loss:
            wd = float(helper.weight_decay_loss(snapshot['params'], exclude_bn=exclude_bn))
            out['loss'] = np.asarray(float(metrics['ce']) + wd)
        return out
    return run


def _setup(case):
    """The JAX side of a case on a 2-device mesh: the snapshot, the global
    batch, the JAX step's state and its reruns'."""
    flags = FLAGS_OF[case]
    mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:WORLD], ('data',), (WORLD,)))
    try:
        with JFLAGS.scope(**flags):
            learner, state, tx = _jax_learner(case, flags)
            assert learner.global_batch_size == WORLD * BATCH
        cls = type(learner.dataset_train)
        learner.dataset_train.augment_xy = lambda batch, rng, is_train: cls.augment_xy(
            learner.dataset_train, batch, rng, False)
        snapshot = jax.tree_util.tree_map(np.array, jax.device_get(
            {'params': state.params, 'batch_stats': state.batch_stats,
             'opt_state': state.opt_state, 'extra': state.extra}))
        with JFLAGS.scope(**flags):
            images, labels = learner.dataset_train.synthesize_arrays(64)
        if case == 'act8':
            snapshot['params'], images, labels = exact_regime(snapshot['params'], images, labels)
            # rank 1's rows: no white block and sparse white pixels (1 in 5),
            # so that no site of theirs reaches the global range of 255 u
            dim = np.random.default_rng(7).random(images[BATCH:WORLD * BATCH].shape) < 0.2
            images[BATCH:WORLD * BATCH] = np.where(dim, 255, 0).astype(np.uint8)
        if case == 'uniform-tf':
            rng = np.random.default_rng(3)
            nb = len(snapshot['extra']['act_max'])
            snapshot['extra'] = {'act_min': np.zeros(nb, np.float32),
                                 'act_max': rng.uniform(1.5, 4.0, nb).astype(np.float32)}
        images, labels = images[:WORLD * BATCH], labels[:WORLD * BATCH]
        jstep = _jax_step(case, flags, learner, state, tx)
        if case == 'act8':  # the exact regime's floor: the reversed batch only
            want = jstep(snapshot, images, labels)
            reruns = [jstep(snapshot, images[::-1].copy(), labels[::-1].copy())]
        else:
            want, reruns = jax_runs(jstep, snapshot, images, labels)
        # and the same step on one device at the global batch: the JAX
        # package's own sums in the other order
        flags1 = dict(flags, batch_size=WORLD * BATCH)
        mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:1], ('data',), (1,)))
        with JFLAGS.scope(**flags1):
            learner1, state1, tx1 = _jax_learner(case, flags1)
        learner1.dataset_train.augment_xy = learner.dataset_train.augment_xy
        jax_world1 = _jax_step(case, flags1, learner1, state1, tx1)(snapshot, images, labels)
        reruns.append(jax_world1)
    finally:
        mesh_lib.reset_global_mesh()
    port_snapshot = {k: snapshot[k] for k in ('params', 'batch_stats')}
    if CASES[case][1] in ('uniform-tf', 'non-uniform'):
        port_snapshot['extra'] = {k: v for k, v in snapshot['extra'].items() if k != 'w_bits'}
    return dict(flags=flags, snapshot=port_snapshot, images=images, labels=labels, want=want,
                reruns=reruns, jax_world1=jax_world1)


def _port_world1(env):
    """One port rank (no group) at the global batch of 16."""
    flags = dict(env['flags'], batch_size=WORLD * BATCH)
    return port_step(env['case'], flags, env['snapshot'], env['images'], env['labels'])


@pytest.fixture(scope='module', params=list(CASES))
def dist_case(request, tmp_path_factory):
    case = request.param
    env = _setup(case)
    env['case'] = case
    env['ranks'] = launch.spawn(
        'torch_dist_ranks:port_step', WORLD,
        {'case': case, 'flags': env['flags'], 'snapshot': env['snapshot'],
         'images': env['images'], 'labels': env['labels']},
        work_dir=str(tmp_path_factory.mktemp('ranks')), paths=[TESTS])
    env['world1'] = _port_world1(env)
    return env


def _got(env, rank=0):
    got = dict(env['ranks'][rank]['state'])
    if 'loss' in env['want']:
        got['loss'] = np.asarray(env['ranks'][rank]['loss'])
    return got


def test_two_ranks_match_jax_on_a_two_device_mesh(dist_case):
    assert [r['world'] for r in dist_case['ranks']] == [WORLD, WORLD]
    assert out_of_bound(dist_case['want'], dist_case['reruns'], _got(dist_case)) == []


def test_ranks_are_bit_identical(dist_case):
    first, second = dist_case['ranks']
    assert first['checksum'] == second['checksum']
    assert first['loss'] == second['loss']
    assert all(np.array_equal(first['state'][k], second['state'][k]) for k in first['state'])


def test_collectives_of_a_step(dist_case):
    """One gradient all-reduce a step; two a BN (forward, backward) in train
    mode; one an activation site at 8 bits; one the EMA ranges; nothing else."""
    counts = dist_case['ranks'][0]['counts']
    state = dist_case['ranks'][0]['state']
    nb_bn = sum(1 for k in state if k.endswith('/mean'))
    expected = {'full-prec': 1 + 2 * nb_bn, 'ghost-bn': 1 + 2 * nb_bn, 'act8': 1 + 3,
                'uniform-tf': 1 + 2 * nb_bn + 1, 'non-uniform': 1 + 2 * nb_bn}
    assert counts == {'all_reduce': expected[dist_case['case']], 'broadcast': 0, 'barrier': 0}


def test_two_ranks_equal_one_rank_at_the_global_batch(dist_case):
    """World 2 at batch 8 against world 1 at batch 16 (no collective), from
    the same state: each tensor, and the loss, within rtol 1e-4, atol 1e-5
    plus 2x the JAX package's own 2-device vs 1-device difference."""
    one = dist_case['world1']
    assert one['world'] == 1 and one['counts'] == {'all_reduce': 0, 'broadcast': 0,
                                                   'barrier': 0}
    want = dict(one['state'])
    if 'loss' in dist_case['want']:
        want['loss'] = np.asarray(one['loss'], np.float32)
    jax_spread = {k: dist_case['want'][k] - dist_case['jax_world1'][k] for k in want}
    # the floor: ||jax_w2 - jax_w1|| about port_w1 (out_of_bound measures
    # each rerun's distance from `want`)
    rerun = {k: want[k] + jax_spread[k] for k in want}
    assert out_of_bound(want, [rerun], _got(dist_case)) == []


def test_sync_bn_function_matches_one_process_bn(tmp_path):
    """_SyncBatchNorm on two ranks (float64, 4 rows each) against autograd
    through one-process BN over the 8 rows: y and dx of each rank's rows, the
    batch statistics on each rank, and the scale's and bias's gradients
    summed over the ranks (the step's all-reduce then takes their mean),
    within 1e-6."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 3, 5, 5)) * 2.0 + 0.5
    dy = rng.standard_normal(x.shape)
    scale, bias, epsilon = rng.uniform(0.5, 1.5, 3), rng.standard_normal(3), 1e-5
    ranks = launch.spawn('torch_dist_ranks:sync_bn', WORLD,
                         dict(x=x, dy=dy, scale=scale, bias=bias, epsilon=epsilon),
                         work_dir=str(tmp_path), paths=[TESTS])
    xt, st, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias))
    mean = xt.mean(dim=(0, 2, 3))
    var = (xt - mean[:, None, None]).square().mean(dim=(0, 2, 3))
    y = ((xt - mean[:, None, None]) / torch.sqrt(var + epsilon)[:, None, None]
         * st[:, None, None] + bt[:, None, None])
    (y * torch.from_numpy(dy)).sum().backward()
    for rank, out in enumerate(ranks):
        rows = slice(4 * rank, 4 * rank + 4)
        np.testing.assert_allclose(out['y'], y.detach().numpy()[rows], rtol=0, atol=1e-6)
        np.testing.assert_allclose(out['dx'], xt.grad.numpy()[rows], rtol=0, atol=1e-6)
        np.testing.assert_allclose(out['mean'], mean.detach().numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(out['var'], var.detach().numpy(), rtol=0, atol=1e-6)
    for key, want in (('dscale', st.grad), ('dbias', bt.grad)):
        np.testing.assert_allclose(sum(out[key] for out in ranks), want.numpy(), rtol=0,
                                   atol=1e-6)
