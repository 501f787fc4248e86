"""The port's channel pruner and the 'channel' learner
(pocketflow_tpu_torch/learners/channel_pruning/{channel_pruner,learner}.py)
against the JAX package's, on the CPU in fp32.

* conv_layer_specs on ConvNet, ResNet-20 and MobileNet-v1 (224): the same
  paths, kernel shapes, strides, padding, shapes and FLOPs (20 prunable
  convs in ResNet-20, the two projection shortcuts included; MobileNet-v1's
  13 pointwise convs), and InputCapturePolicy / augment_images equal;
* the sampler at the positions the JAX sampler draws: X and Y within
  rtol 1e-5 / atol 1e-5 on a 'SAME' stride-2 conv (the odd pad row at the
  end) and a 'VALID' one, each pair satisfying Y = sum_c X_c * W_c, X from
  the current net and Y from the original;
* the Gram-form ISTA against the JAX solver: |beta_port - beta_jax| within
  1e-5 of max |beta_jax| (+1e-6); select_channels the same channel set,
  with the count-0 magnitude fallback and the quadruple option;
* prune_layer in both modes: the same channels, the kernel within 1e-4 of
  its norm;
* AmcRLHelper (states, constrained actions, rewards) and _merge_topk equal;
  the budget holds, and a helper without the later_min term (planted
  fault) breaks it;
* a two-layer sequential prune of ResNet-20 through both learners'
  prune_with_ratios at the JAX sampler's positions: the same masks, the
  kernels within 1e-3 of their norm; X taken from the original net
  (planted fault) fails it;
* copy_state isolation: two prune passes with equal ratios and seeds give
  equal masks and kernels, the baseline unchanged;
* the AMC search (2 roll-outs, the eval set poisoned): the budget, the top-k
  in ddpg_search.npz, and a resume from a checkpoint the JAX agent wrote;
* ConvNet @ FMNIST end to end at the JAX test's sizes, and main.main with
  --learner=channel (uniform with --enbl_dst, list with --cp_finetune, auto),
  then --exec_mode=eval.
"""

import copy
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.core import mesh as mesh_lib
from pocketflow_tpu.learners.channel_pruning import channel_pruner as jcp
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core.bridge import load_jax_numpy
from pocketflow_tpu_torch.learners.channel_pruning import channel_pruner as tcp

torch.set_num_threads(2)
SMALL = dict(synthetic_data=True, compute_dtype='float32', rand_seed=0, batch_size=8,
             batch_size_eval=8, nb_smpls_train=64, nb_smpls_eval=16)


@pytest.fixture(autouse=True)
def _port_flags(monkeypatch):
    """Restore the port's flags after each test; the JSONL summaries spare
    the tests TensorBoard's imports."""
    import pocketflow_tpu_torch.learners.channel_pruning.learner  # noqa: F401  (cp_* flags)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _jax_mesh():
    mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:1], ('data',), (1,)))


def _models(model):
    """(JAX module, variables, port module loaded with them, NHWC images)."""
    if model == 'mobilenet_v1':
        from pocketflow_tpu.nets.mobilenet import MobileNetV1 as J
        from pocketflow_tpu_torch.nets.mobilenet import MobileNetV1 as T
        jm, tm = J(nb_classes=1001, dtype=jnp.float32), T(nb_classes=1001, dtype=torch.float32)
        x = np.random.default_rng(0).normal(size=(1, 224, 224, 3)).astype(np.float32)
        variables = jax.device_get(jax.jit(lambda v: jm.init(jax.random.PRNGKey(0), v,
                                                               train=False))(jnp.asarray(x)))
        load_jax_numpy(tm, variables['params'], variables['batch_stats'])
        return jm, variables, tm.eval(), x
    from test_torch_zoo import _setup
    return _setup(model)


# ---------------------------------------------------------------------------
# specs, capture, the sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('model,nb_prunable', [('convnet_at_fmnist', 1),
                                               ('resnet_at_cifar10', 20),
                                               ('mobilenet_v1', 13)])
def test_conv_layer_specs_match_jax(model, nb_prunable):
    jm, variables, tm, x = _models(model)
    want = jcp.conv_layer_specs(jm, variables['params'], variables.get('batch_stats', {}),
                                jnp.asarray(x))
    got = tcp.conv_layer_specs(tm, torch.from_numpy(x))
    assert [s['path'] for s in got] == [s['path'] for s in want]
    for g, w in zip(got, want):
        for key in ('kernel_shape', 'strides', 'padding', 'in_shape', 'out_shape', 'flops'):
            assert tuple(np.ravel(g[key])) == tuple(np.ravel(w[key])), (g['path'], key)
    # the 'channel' learner's filter: the stem (c_in <= 3) is never pruned
    assert len([s for s in got if s['kernel_shape'][2] > 3]) == nb_prunable


def test_input_capture_and_augment_images_match_jax():
    from pocketflow_tpu.datasets.cifar10 import Cifar10Dataset as JData
    from pocketflow_tpu_torch.datasets.cifar10 import Cifar10Dataset as TData
    jm, variables, tm, x = _models('resnet_at_cifar10')
    with JFLAGS.scope(**SMALL), TFLAGS.scope(**SMALL):
        images, labels = TData(True).synthesize_arrays(8)
        batch = {'image': images[:2], 'label': labels[:2]}
        want = np.asarray(JData(True).augment_images(
            {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0), False))
        got = TData(True).augment_images({k: torch.from_numpy(v) for k, v in batch.items()},
                                         None, False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    from pocketflow_tpu.nn.layers import compression as jcompression
    jrec = jcp.InputCapturePolicy()
    with jcompression(jrec):
        jm.apply(variables, jnp.asarray(x), train=False)
    trec = tcp.run_until(tm, torch.from_numpy(x), tcp.InputCapturePolicy())
    assert [p for p, _ in trec.inputs] == [p for p, _ in jrec.inputs]
    for (path, g), (_, w) in zip(trec.inputs, jrec.inputs):
        g = g.numpy().transpose(0, 2, 3, 1) if g.dim() == 4 else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=path)
    # `only` + `stop`: the one layer's input, and a forward ended there
    one = tcp.run_until(tm, torch.from_numpy(x),
                        tcp.InputCapturePolicy(only='stage2_block0/conv1', stop='input'))
    assert [p for p, _ in one.inputs] == ['stage2_block0/conv1'] and not one.captured


def _jax_positions(rng, spec, batch_size, nb_pts):
    k1, k2 = jax.random.split(rng)
    yi = jax.random.randint(k1, (batch_size * nb_pts,), 0, spec['out_shape'][1])
    xi = jax.random.randint(k2, (batch_size * nb_pts,), 0, spec['out_shape'][2])
    return torch.from_numpy(np.array(yi)).long(), torch.from_numpy(np.array(xi)).long()


@pytest.mark.parametrize('model,path,padding', [
    ('resnet_at_cifar10', 'stage2_block0/conv1', 'SAME'),
    ('lenet_at_cifar10', 'conv2', 'VALID')])
def test_sampler_matches_jax_at_its_positions(model, path, padding):
    from test_torch_zoo import _setup
    if model == 'resnet_at_cifar10':
        from pocketflow_tpu.datasets.cifar10 import Cifar10Dataset as JData
        from pocketflow_tpu_torch.datasets.cifar10 import Cifar10Dataset as TData
    else:
        from pocketflow_tpu.nets.lenet_at_cifar10 import ModelHelper as JH
        from pocketflow_tpu_torch.nets.lenet_at_cifar10 import ModelHelper as TH
        JData = lambda train: JH().build_dataset_train()  # noqa: E731
        TData = lambda train: TH().build_dataset_train()  # noqa: E731
    nb_pts = 6
    flags = dict(SMALL, batch_size=4, cp_nb_points_per_layer=nb_pts)
    jm, variables, tm, x = _setup(model)
    params, bstats = variables['params'], variables.get('batch_stats', {})
    with JFLAGS.scope(**flags), TFLAGS.scope(**flags):
        jdata, tdata = JData(True), TData(True)
        images, labels = tdata.synthesize_arrays(8)
        batch = {'image': images[:4], 'label': labels[:4]}
        specs = jcp.conv_layer_specs(jm, params, bstats, jnp.asarray(x))
        spec = next(s for s in specs if s['path'] == path)
        assert spec['padding'] == padding
        # the current net: the first conv's kernel halved (an upstream prune)
        cur = copy.deepcopy(jax.device_get(params))
        first = specs[0]['path']
        cur[first]['kernel'] = np.asarray(cur[first]['kernel']) * 0.5
        rng = jax.random.PRNGKey(2)
        jX, jY = jcp.ChannelPruner(jm, jdata, specs)._sampler(spec)(
            params, bstats, cur, bstats, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        tcur = copy.deepcopy(tm)
        with torch.no_grad():
            dict(tcur.named_parameters())[first.replace('/', '.') + '.kernel'].mul_(0.5)
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        positions = _jax_positions(rng, spec, 4, nb_pts)
        tX, tY = tcp.ChannelPruner(tdata, specs).sample(spec, tm, tcur, tbatch,
                                                        positions=positions)
        # Y is the ORIGINAL net's output at the windows' positions: the
        # identity holds for X from the original net, not from the current one
        X0, Y0 = tcp.ChannelPruner(tdata, specs).sample(spec, tm, tm, tbatch,
                                                        positions=positions)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tY.numpy(), np.asarray(jY), rtol=1e-5, atol=1e-5)
    W = dict(tm.named_parameters())[path.replace('/', '.') + '.kernel'].detach().numpy()
    np.testing.assert_allclose(np.einsum('pchw,hwco->po', X0.numpy(), W), Y0.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(Y0.numpy(), tY.numpy())
    assert not np.allclose(np.einsum('pchw,hwco->po', tX.numpy(), W), tY.numpy(), atol=2e-2)


# ---------------------------------------------------------------------------
# the LASSO, select_channels, prune_layer
# ---------------------------------------------------------------------------

def _lasso_data(seed=0, n=200, c=16):
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(n, c)).astype(np.float32)
    beta_true = np.zeros(c, np.float32)
    beta_true[[2, 7, 11]] = [1.5, -2.0, 0.8]
    return P, (P @ beta_true + 0.05 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize('alpha', [0.0, 1.0, 10.0, 1e5])
def test_lasso_solver_matches_jax(alpha):
    P, y = _lasso_data()
    want = np.asarray(jcp.make_lasso_solver(nb_iters=500)(jnp.asarray(P), jnp.asarray(y),
                                                           jnp.float32(alpha)))
    got = tcp.make_lasso_solver(nb_iters=500)(
        tcp.lasso_problem(torch.from_numpy(P), torch.from_numpy(y)), alpha).numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want)) + 1e-6
    np.testing.assert_array_equal(np.abs(got) > 1e-12, np.abs(want) > 1e-12)


def _select_case(case):
    rng = np.random.default_rng(1)
    if case == 'degenerate':  # y == 0: no channel survives any alpha
        P = rng.normal(size=(200, 32)).astype(np.float32)
        P[:, 16:] *= 10.0
        return P, np.zeros(200, np.float32), 16
    P = rng.normal(size=(300, 32)).astype(np.float32)
    scales = np.ones(32, np.float32) * 0.05
    scales[:8] = 2.0
    scales[8:14] = np.linspace(0.3, 1.0, 6)
    P = P * scales
    return P, (P @ np.ones(32, np.float32)).astype(np.float32), 10 if case == 'quadruple' else 8


@pytest.mark.parametrize('case', ['target', 'degenerate', 'quadruple'])
def test_select_channels_matches_jax(case):
    P, y, c_new = _select_case(case)
    quadruple = case == 'quadruple'
    with JFLAGS.scope(cp_quadruple=quadruple), TFLAGS.scope(cp_quadruple=quadruple):
        want = jcp.select_channels(P, y, c_new, jcp.make_lasso_solver(nb_iters=400))
        got = tcp.select_channels(torch.from_numpy(P), torch.from_numpy(y), c_new,
                                  tcp.make_lasso_solver(nb_iters=400)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == 'degenerate':  # the magnitude fallback keeps the requested count
        assert got.sum() == 16 and got[16:].all()
    if case == 'quadruple':
        assert got.sum() % 4 == 0


@pytest.mark.parametrize('lasso', [True, False])
def test_prune_layer_matches_jax(lasso):
    h, w, c_in, c_out = 3, 3, 16, 8
    rng = np.random.default_rng(3)
    kernel = rng.normal(size=(h, w, c_in, c_out)).astype(np.float32) * 0.1
    kernel[:, :, [1, 4, 6, 7, 9, 12], :] *= 10.0
    X = rng.normal(size=(400, c_in, h, w)).astype(np.float32)
    Y = (np.einsum('pchw,hwco->po', X, kernel)
         + 0.1 * rng.normal(size=(400, c_out))).astype(np.float32)
    spec = {'path': 'conv', 'kernel_shape': (h, w, c_in, c_out)}
    flags = dict(cp_lasso=lasso, cp_lasso_nb_iters=300, rand_seed=0)
    with JFLAGS.scope(**flags), TFLAGS.scope(**flags):
        jpruner = jcp.ChannelPruner.__new__(jcp.ChannelPruner)
        jpruner.solver = jcp.make_lasso_solver()
        want_k, want_i = jcp.ChannelPruner.prune_layer(jpruner, spec, jnp.asarray(kernel), X, Y,
                                                       preserve_ratio=0.5)
        got_k, got_i = tcp.ChannelPruner(None, [spec]).prune_layer(
            spec, torch.from_numpy(kernel), torch.from_numpy(X), torch.from_numpy(Y), 0.5)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert got_i.sum() == 8
    want_k = np.asarray(want_k)
    assert np.linalg.norm(got_k.numpy() - want_k) <= 1e-4 * np.linalg.norm(want_k)
    assert not np.any(got_k.numpy()[:, :, ~got_i.numpy(), :])


# ---------------------------------------------------------------------------
# AMC helper, top-k
# ---------------------------------------------------------------------------

def _amc_specs(rng, nb=6):
    specs = []
    for i in range(nb):
        c_in, c_out = int(rng.integers(8, 64)), int(rng.integers(8, 64))
        hw = int(rng.choice([8, 16, 32]))
        specs.append({'path': 'c%d' % i, 'kernel_shape': (3, 3, c_in, c_out),
                      'strides': (1 + i % 2, 1 + i % 2), 'in_shape': (1, hw, hw, c_in),
                      'out_shape': (1, hw, hw, c_out),
                      'flops': float(2 * hw * hw * 9 * c_in * c_out)})
    return specs


@pytest.mark.parametrize('policy', ['accuracy', 'flops'])
def test_amc_rl_helper_matches_jax(policy):
    from pocketflow_tpu.learners.channel_pruning.learner import AmcRLHelper as J
    from pocketflow_tpu_torch.learners.channel_pruning.learner import AmcRLHelper as T
    rng = np.random.default_rng(4)
    specs = _amc_specs(rng)
    jh, th = J(specs, 0.4), T(specs, 0.4)
    with JFLAGS.scope(cp_reward_policy=policy), TFLAGS.scope(cp_reward_policy=policy):
        for _ in range(3):
            jh.reset()
            th.reset()
            for idx in range(len(specs)):
                np.testing.assert_array_equal(th.calc_state(idx), jh.calc_state(idx))
                action = float(rng.uniform())
                assert th.constrain_action(idx, action) == jh.constrain_action(idx, action)
            for acc in (0.7, float('nan')):
                assert th.calc_reward(acc) == jh.calc_reward(acc)
            assert th.preserved_flops() == jh.preserved_flops()


def _constrain_without_later_min(self, idx, action):
    """AmcRLHelper.constrain_action without the later layers' ratio_min
    term (a planted fault)."""
    action = min(1.0, max(0.0, float(action)))
    decided = float(np.sum(self.flops[self.decided] * self.ratios[self.decided]))
    max_action = (self.desired_preserve - decided) / max(float(self.flops[idx]), 1.0)
    action = max(self.ratio_min, min(action, max(self.ratio_min, max_action)))
    self.ratios[idx], self.decided[idx], self.prev_action = action, True, action
    return action


def _greedy_preserved(helper):
    helper.reset()
    for idx in range(helper.nb_layers):
        helper.calc_state(idx)
        helper.constrain_action(idx, 1.0)
    return helper.preserved_flops()


def test_amc_budget_holds_and_fails_without_later_min():
    from pocketflow_tpu_torch.learners.channel_pruning.learner import AmcRLHelper
    specs = [{'path': 'c%d' % i, 'kernel_shape': (3, 3, 16, 16), 'strides': (1, 1),
              'in_shape': (1, 8, 8, 16), 'out_shape': (1, 8, 8, 16), 'flops': f}
             for i, f in enumerate([100.0, 300.0, 600.0])]
    helper = AmcRLHelper(specs, preserve_ratio=0.5)
    assert _greedy_preserved(helper) <= helper.desired_preserve + 1e-9
    assert np.all(helper.ratios >= helper.ratio_min)
    faulty = type('Faulty', (AmcRLHelper,), {'constrain_action': _constrain_without_later_min})
    helper = faulty(specs, preserve_ratio=0.5)
    assert _greedy_preserved(helper) > helper.desired_preserve + 1e-9


def test_merge_topk_matches_jax():
    from pocketflow_tpu.learners.channel_pruning.learner import _merge_topk as J
    from pocketflow_tpu_torch.learners.channel_pruning.learner import _merge_topk as T
    rng = np.random.default_rng(5)
    jc, tc = [], []
    for i in range(30):
        reward = float(rng.uniform())
        ratios = list(np.round(rng.uniform(0.2, 1.0, size=4), 2)) if i % 3 else [0.5] * 4
        jc, tc = J(jc, reward, ratios, k=4), T(tc, reward, ratios, k=4)
        assert tc == jc
    assert len(tc) == 4 and [r for r, _ in tc] == sorted((r for r, _ in tc), reverse=True)


# ---------------------------------------------------------------------------
# sequential prune passes
# ---------------------------------------------------------------------------

TWO_LAYER = dict(SMALL, cp_nb_batches=2, cp_nb_points_per_layer=10, cp_lasso_nb_iters=300)


def _two_layer_runs(x_from_original=False):
    """Both learners' prune_with_ratios on ResNet-20 from one bridged state:
    the first two prunable convs at 0.5, the rest kept, the port's sampler
    at the positions the JAX sampler drew, both on the same batches.
    Returns ({path: (jax kernel, port kernel, jax mask, port mask)})."""
    from pocketflow_tpu.learners.channel_pruning.learner import ChannelPrunedLearner as JL
    from pocketflow_tpu.nets.resnet_at_cifar10 import ModelHelper as JH
    from pocketflow_tpu_torch.learners.channel_pruning.learner import ChannelPrunedLearner as TL
    from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper as TH
    _jax_mesh()
    with JFLAGS.scope(**TWO_LAYER), TFLAGS.scope(**TWO_LAYER):
        jl = JL(None, JH())
        jstate, _, _ = jl.init_state()
        jl._setup_pruner(jstate)
        images, labels = jl.dataset_train.synthesize_arrays(64)
        batches = [{'image': images[i * 8:(i + 1) * 8], 'label': labels[i * 8:(i + 1) * 8]}
                   for i in range(4)]
        calls = []
        sampler = jl.pruner._sampler

        def recording(spec):
            fn = sampler(spec)

            def wrapped(op, ob, cp, cb, batch, rng):
                calls.append((spec, rng))
                return fn(op, ob, cp, cb, batch, rng)
            return wrapped

        jl.pruner._sampler = recording
        jl._cp_train_iter = iter(batches)
        ratios = [0.5, 0.5] + [1.0] * (len(jl.specs) - 2)
        jpruned, jmasks = jl.prune_with_ratios(jstate, ratios)

        tl = TL(None, TH(), device='cpu')
        tstate, _, _ = tl.init_state()
        load_jax_numpy(tstate.model, jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
        tl._setup_pruner(tstate)
        assert [s['path'] for s in tl.specs] == [s['path'] for s in jl.specs]
        tl._cp_train_iter = iter([tl.put_batch(b) for b in batches])
        positions = {}
        for spec, rng in calls:
            positions.setdefault(spec['path'], []).append(_jax_positions(rng, spec, 8, 10))
        collect = tl.pruner.collect

        def collect_at_jax_positions(spec, orig, cur, batches_, generator):
            return collect(spec, orig, orig if x_from_original else cur, batches_, generator,
                           positions[spec['path']])

        tl.pruner.collect = collect_at_jax_positions
        before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
        tpruned, tmasks = tl.prune_with_ratios(tstate, ratios)
        assert all(torch.equal(before[k], v) for k, v in tstate.model.state_dict().items())
    mesh_lib.reset_global_mesh()
    jparams = jax.device_get(jpruned.params)
    tparams = dict(tpruned.model.named_parameters())
    out = {}
    for spec in tl.specs[:2]:
        keys = spec['path'].split('/')
        node, jm = jparams, jax.device_get(jmasks)
        for key in keys:
            node, jm = node[key], jm[key]
        name = spec['path'].replace('/', '.') + '.kernel'
        out[spec['path']] = (np.asarray(node['kernel']), tparams[name].detach().numpy(),
                             np.asarray(jm['kernel']), tmasks[name].numpy())
    return out


def _two_layer_faults(runs):
    bad = []
    for path, (jk, tk, jm, tm) in runs.items():
        if not np.array_equal(jm, tm):
            bad.append((path, 'mask'))
        elif np.linalg.norm(tk - jk) > 1e-3 * np.linalg.norm(jk):
            bad.append((path, 'kernel', float(np.linalg.norm(tk - jk) / np.linalg.norm(jk))))
    return bad


def test_two_layer_sequential_prune_matches_jax():
    runs = _two_layer_runs()
    assert len(runs) == 2
    for path, (jk, tk, jm, tm) in runs.items():
        assert tm.shape == (1, 1, 16, 1) and tm.sum() == 8, path
        assert not np.any(tk[:, :, tm.reshape(-1) == 0, :]), path
    assert _two_layer_faults(runs) == []


def test_two_layer_prune_with_x_from_the_original_net_fails():
    """Planted fault: the second layer's X from the ORIGINAL net (the first
    layer unpruned) instead of the current one."""
    bad = _two_layer_faults(_two_layer_runs(x_from_original=True))
    assert [b[0] for b in bad] == ['stage1_block0/conv2'], bad


def _port_learner(tmp_path, helper='convnet', **flags):
    from pocketflow_tpu_torch.learners.channel_pruning.learner import ChannelPrunedLearner
    if helper == 'convnet':
        from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    else:
        from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper
    TFLAGS.override(**{**SMALL, 'save_path': str(tmp_path / 'models' / 'model.ckpt'),
                       'cp_channel_pruned_path': str(tmp_path / 'cp' / 'model.ckpt'),
                       'cp_best_path': str(tmp_path / 'cp' / 'best_model.ckpt'),
                       'log_dir': str(tmp_path / 'logs'), **flags})
    return ChannelPrunedLearner(None, ModelHelper(), device='cpu')


def test_prune_passes_start_from_the_same_baseline(tmp_path):
    learner = _port_learner(tmp_path, helper='resnet', cp_nb_batches=1,
                            cp_nb_points_per_layer=4, cp_lasso_nb_iters=50)
    state, _, _ = learner.init_state()
    learner._setup_pruner(state)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    images, labels = learner.dataset_train.synthesize_arrays(64)
    batches = [learner.put_batch({'image': images[i * 8:(i + 1) * 8],
                                  'label': labels[i * 8:(i + 1) * 8]}) for i in range(8)]
    ratios = [0.5] * 3 + [1.0] * (len(learner.specs) - 3)
    runs = []
    for _ in range(2):
        learner._seeds = np.random.default_rng(7)
        learner._cp_train_iter = iter(batches)
        pruned, masks = learner.prune_with_ratios(state, ratios)
        runs.append(({k: v.clone() for k, v in pruned.model.state_dict().items()}, masks))
    after = state.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    (p1, m1), (p2, m2) = runs
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert sum(int(m.dim() > 0 and (m == 0).any()) for m in m1.values()) == 3
    assert any(not torch.equal(p1[k], before[k]) for k in before)


# ---------------------------------------------------------------------------
# the AMC search, end to end, main.main
# ---------------------------------------------------------------------------

SEARCH = dict(batch_size=16, nb_smpls_train=256, nb_smpls_eval=64, nb_smpls_val=64,
              batch_size_eval=16, nb_epochs_rat=0.01, lrn_rate_init=0.05,
              cp_prune_option='auto', cp_preserve_ratio=0.5, cp_nb_rlouts=2,
              cp_nb_rlouts_min=1, cp_nb_batches=2, cp_nb_points_per_layer=4,
              cp_lasso_nb_iters=100)


def test_amc_search_meets_the_budget_and_resumes_a_jax_search(tmp_path):
    from pocketflow_tpu.rl_agents.ddpg.agent import DdpgAgent as JAgent
    learner = _port_learner(tmp_path, **SEARCH)

    def poisoned(*args, **kwargs):
        raise AssertionError('AMC search read the eval set')

    learner.dataset_eval.build = poisoned
    state, _, _ = learner.init_state()
    learner._setup_pruner(state)
    ratios = learner.search_ratios_rl(state)
    assert len(ratios) == len(learner.specs) == 1
    assert all(0.0 < r <= 1.0 for r in ratios)
    flops = np.array([s['flops'] for s in learner.specs])
    assert float(np.sum(flops * np.asarray(ratios))) <= 0.5 * float(flops.sum()) + 1e-6
    path = tmp_path / 'cp' / 'ddpg_search.npz'
    blob = np.load(path)
    assert int(blob['x_idx_rlout']) == 1
    assert 1 <= len(learner.search_topk) <= 5
    rewards = [r for r, _ in learner.search_topk]
    assert rewards == sorted(rewards, reverse=True)
    assert blob['x_rewards_topk'].shape[0] == len(learner.search_topk)
    assert blob['x_ratios_topk'].shape == (len(learner.search_topk), 1)
    assert len(learner.rollout_times) == 2
    assert set(learner.rollout_times[0]) == {'sample', 'lasso', 'ridge', 'feval', 'total'}
    # the port's own checkpoint: a third roll-out resumes after the two saved
    with TFLAGS.scope(cp_nb_rlouts=3):
        learner.search_ratios_rl(state)
    assert int(np.load(path)['x_idx_rlout']) == 2 and len(learner.rollout_times) == 3

    # a search the JAX package wrote, at roll-out #4 with its best and top-k
    os.remove(path)
    with JFLAGS.scope(**SMALL):
        agent = JAgent(s_dims=10, a_dims=1, nb_rlouts=6, buf_size=1, seed=0)
        agent.init()
        agent.save_search(str(path), extras={
            'idx_rlout': 4, 'reward_best': 2.0, 'ratios_best': np.asarray([0.4], np.float32),
            'rewards_topk': np.asarray([2.0, 1.5], np.float32),
            'ratios_topk': np.asarray([[0.4], [0.3]], np.float32)})
    with TFLAGS.scope(cp_nb_rlouts=6):
        ratios = learner.search_ratios_rl(state)
    blob = np.load(path)
    assert int(blob['x_idx_rlout']) == 5  # one roll-out after the JAX search's five
    assert blob['state'][:2].tobytes() == b'PK'  # now the port's own checkpoint
    assert ratios == [pytest.approx(0.4)]  # no roll-out beats the reward of 2
    assert learner.search_topk[:2] == [(2.0, [pytest.approx(0.4)]),
                                       (1.5, [pytest.approx(0.3)])]


def _conv2_kept(model):
    k = dict(model.named_parameters())['conv2.kernel'].detach().numpy()
    return int(np.sum(np.linalg.norm(k.transpose(2, 0, 1, 3).reshape(32, -1), axis=1) > 0))


def test_channel_pruned_uniform_end_to_end(tmp_path):
    """The JAX test's sizes and invariants (tests/test_channel_pruning.py):
    about half of conv2's 32 input channels kept, accuracy above 0.5."""
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    flags = dict(batch_size=16, nb_smpls_train=480, nb_smpls_eval=128, batch_size_eval=32,
                 nb_epochs_rat=0.05, lrn_rate_init=0.05)
    learner = _port_learner(tmp_path, **flags)
    FullPrecLearner(None, ModelHelper(), device='cpu').train()
    with TFLAGS.scope(cp_prune_option='uniform', cp_uniform_preserve_ratio=0.5,
                      cp_nb_batches=4, cp_nb_points_per_layer=6, cp_nb_iters_ft_ratio=0.3):
        learner = _port_learner(tmp_path, **flags)
        state = learner.train()
        assert _conv2_kept(state.model) <= 20
        metrics = learner.run_eval_loop(state, learner.build_eval_step())
        assert metrics['accuracy'] > 0.5


@pytest.mark.parametrize('option', ['uniform', 'list', 'auto', 'schedule'])
def test_main_runs_channel(tmp_path, option):
    """python -m pocketflow_tpu_torch.main --learner=channel from a full-prec
    baseline (uniform with --enbl_dst; list with --cp_finetune; auto, a
    2-roll-out search; uniform with --cp_finetune_schedule, the model's
    schedule replayed from step 0), then --exec_mode=eval from its
    checkpoint."""
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.learners.channel_pruning.learner import ChannelPrunedLearner
    if 'model' in TFLAGS:
        TFLAGS.model = TFLAGS._specs['model'].default
    (tmp_path / 'ratio.list').write_text('0.5\n')
    argv = ['--synthetic_data', '--nb_smpls_train=64', '--nb_smpls_eval=16', '--batch_size=8',
            '--batch_size_eval=8', '--compute_dtype=float32', '--summ_step=1',
            '--log_dir=%s' % (tmp_path / 'logs'),
            '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt'),
            '--cp_channel_pruned_path=%s' % (tmp_path / 'cp' / 'model.ckpt'),
            '--cp_best_path=%s' % (tmp_path / 'cp' / 'best_model.ckpt')]
    port_main.main(argv + ['--nb_epochs_rat=0.01'], device='cpu')
    cp = argv + ['--learner=channel', '--nb_epochs_rat=0.1',
                 '--cp_prune_option=%s' % ('uniform' if option == 'schedule' else option),
                 '--cp_uniform_preserve_ratio=0.5', '--cp_nb_batches=2',
                 '--cp_nb_points_per_layer=4', '--cp_lasso_nb_iters=100',
                 '--cp_prune_list_file=%s' % (tmp_path / 'ratio.list'), '--cp_list_group=4',
                 '--cp_nb_rlouts=2', '--cp_nb_rlouts_min=1']
    cp += {'uniform': ['--enbl_dst'], 'list': ['--cp_finetune'], 'auto': [],
           'schedule': ['--cp_finetune_schedule']}[option]
    learner = port_main.main(cp, device='cpu')
    assert isinstance(learner, ChannelPrunedLearner)
    from pocketflow_tpu_torch.core import checkpoint as ckpt
    payload = ckpt.restore_latest(str(tmp_path / 'cp' / 'model.ckpt'))
    mask = payload['extra']['masks']['conv2.kernel']
    kernel = payload['model']['conv2.kernel']
    assert mask.shape == (1, 1, 32, 1)
    if option != 'auto':
        assert int(mask.sum()) == 16
    assert not torch.any(kernel[:, :, mask.reshape(-1) == 0, :])
    # the last step's rate: the constant cp_lrn_rate_ft, or the model's
    # schedule at the scaled step (its 128 steps replayed in 25)
    lr = payload['optimizer']['param_groups'][0]['lr']
    if option == 'schedule':
        from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
        schedule, nb_iters = ModelHelper().setup_lrn_rate(8)
        nb_ft = int(nb_iters * 0.2)
        assert (nb_iters, nb_ft, payload['step']) == (128, 25, 25)
        assert lr == schedule(math.ceil((nb_ft - 1) * nb_iters / nb_ft)) != 1e-4
    else:
        assert lr == 1e-4
    metrics = port_main.main(cp + ['--exec_mode=eval'], device='cpu').evaluate()
    assert np.isfinite(metrics['loss'])
