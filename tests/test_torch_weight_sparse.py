"""The port's weight-sparsification learner and its ratio optimizer
(pocketflow_tpu_torch/learners/weight_sparsification/{pr_optimizer,learner}.py)
against the JAX package's, on ConvNet @ FMNIST (synthetic data, fp32).

* `heurist` ratios: equal to the JAX package's;
* one joint-regression step and one finetune step of the roll-out programs,
  from bridged parameters and the JAX programs' masks, on the same batch of
  8: every parameter after the step within tests/torch_slice_parity.py's
  bound (rtol 1e-4, atol 1e-5 on the L2 norm of the difference, plus 2x the
  spread of JAX reruns with the images or the starting parameters perturbed
  by 1e-7 relative), pruned weights exactly 0 in both, and at least 90% of
  the tensors moved past their bound (so that a wrong step fails);
* the full model bit-unchanged after two roll-outs;
* the `optimal` search (2 roll-outs): a ratio per maskable kernel in [0, 1],
  the overall ratio at least the target - 0.01, and a resume from
  ddpg_search.npz;
* the `uniform` protocol end to end: pr_msk at the target +- 0.02, pruned
  weights exactly 0, evaluate() from the checkpoint;
* main.main with --learner=weight-sparse under each protocol.
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
from pocketflow_tpu_torch.core.bridge import load_jax_numpy
from torch_slice_parity import PERTURBATION, _flat, _tolerance

torch.set_num_threads(2)
BATCH = 8
SMALL = dict(batch_size=BATCH, batch_size_eval=BATCH, nb_smpls_train=64, nb_smpls_eval=16,
             compute_dtype='float32', synthetic_data=True, rand_seed=0, ws_prune_ratio=0.5)


@pytest.fixture(autouse=True)
def _port_flags(monkeypatch):
    """Restore the port's flags after each test; the JSONL summaries spare
    the tests TensorBoard's imports."""
    import pocketflow_tpu_torch.learners.weight_sparsification.learner  # noqa: F401  (ws_* flags)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _port_learner(tmp_path, **flags):
    from pocketflow_tpu_torch.learners.weight_sparsification.learner import WeightSparseLearner
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    TFLAGS.override(**{**SMALL, 'save_path': str(tmp_path / 'models' / 'model.ckpt'),
                       'ws_save_path': str(tmp_path / 'ws' / 'model.ckpt'),
                       'log_dir': str(tmp_path / 'logs'), **flags})
    return WeightSparseLearner(None, ModelHelper(), device='cpu')


def test_heurist_ratios_match_jax(tmp_path):
    from pocketflow_tpu.learners.weight_sparsification.pr_optimizer import PROptimizer as JPR
    from pocketflow_tpu_torch.learners.weight_sparsification import masking
    from pocketflow_tpu_torch.learners.weight_sparsification.pr_optimizer import PROptimizer
    learner = _port_learner(tmp_path, ws_prune_ratio_prtl='heurist', ws_prune_ratio=0.6)
    state, _, _ = learner.init_state()
    pairs = PROptimizer(learner).run(state.model)
    params = dict(state.model.named_parameters())
    with JFLAGS.scope(ws_prune_ratio=0.6):
        want = JPR._heurist([p.replace('.', '/') for p in masking.maskable_paths(params)],
                            masking.maskable_shapes(params))
    assert [(p.replace('.', '/'), r) for p, r in pairs] == want
    assert [p for p, _ in pairs] == ['conv1.kernel', 'conv2.kernel', 'fc3.kernel', 'fc4.kernel']


def test_train_val_split_matches_jax():
    """build(enbl_trn_val_split=True): the first min(nb_smpls_val, n // 5)
    samples, unshuffled, are the validation part, the rest the shuffled
    train part; the same batches as the JAX package's numpy sampler (the
    NumPy iterator in both packages)."""
    from pocketflow_tpu.datasets.fmnist import FMnistDataset as JData
    from pocketflow_tpu_torch.datasets.fmnist import FMnistDataset as TData
    flags = dict(SMALL, nb_smpls_train=64, nb_smpls_val=100)
    with JFLAGS.scope(**flags, enbl_native_loader=False), \
            TFLAGS.scope(**flags, enbl_native_loader=False):
        (jtrn, jval), (ttrn, tval) = (JData(True).build(True), TData(True).build(True))
        for want, got in ((jval, tval), (jtrn, ttrn)):
            for _ in range(3):
                w, g = next(want), next(got)
                np.testing.assert_array_equal(g['image'], w['image'])
                np.testing.assert_array_equal(g['label'], w['label'])
        images = TData(True)._load_arrays()[0]
        val = np.stack([next(tval)['image'] for _ in range(3)])
    # 64 // 5 = 12 validation samples, cycled: the 3 batches of 8 after the
    # 3 above start at sample 24 % 12 = 0
    np.testing.assert_array_equal(val.reshape(-1, *images.shape[1:])[:12], images[:12])


@pytest.mark.parametrize('model', ['convnet_at_fmnist', 'resnet_at_cifar10'])
def test_capture_forward_matches_jax(model):
    """capture_forward_with_output: the same conv/dense paths in call order,
    their outputs and the model's output within 1e-4 of the JAX package's
    (fp32, eval mode); with stop_input_grads, a layer's output takes no
    gradient through the layers before it."""
    from pocketflow_tpu.learners import capture as jcap
    from pocketflow_tpu_torch.learners import capture as tcap
    from test_torch_zoo import _setup
    jm, variables, tm, x = _setup(model)
    jcaptured, jout = jcap.capture_forward_with_output(jm, variables, jnp.asarray(x))
    tcaptured, tout = tcap.capture_forward_with_output(tm, torch.from_numpy(x))
    assert [p for p, _ in tcaptured] == [p for p, _ in jcaptured]
    for (path, got), (_, want) in zip(tcaptured, jcaptured):
        got = got.detach().numpy()
        got = got.transpose(0, 2, 3, 1) if got.ndim == 4 else got
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4, err_msg=path)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    assert all(tcap.regression_paths_filter(model, p) for p, _ in tcaptured)
    last = tcap.capture_forward(tm, torch.from_numpy(x), stop_input_grads=True)[-1][1]
    first_kernel = next(iter(tm.parameters()))
    assert torch.autograd.grad(last.sum(), first_kernel, allow_unused=True)[0] is None


# ---------------------------------------------------------------------------
# the roll-out programs against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def rollout_steps(tmp_path_factory):
    """One regression step and one finetune step in both packages, from the
    same parameters, masks (the JAX programs') and batch."""
    from pocketflow_tpu.learners.weight_sparsification.learner import WeightSparseLearner as JL
    from pocketflow_tpu.learners.weight_sparsification.pr_optimizer import PROptimizer as JPR
    from pocketflow_tpu.nets.convnet_at_fmnist import ModelHelper as JHelper
    from pocketflow_tpu_torch.learners.weight_sparsification import pr_optimizer as tpr
    tmp_path = tmp_path_factory.mktemp('rollout')
    mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:1], ('data',), (1,)))
    out = {}
    with JFLAGS.scope(**SMALL), TFLAGS.scope(**TFLAGS.as_dict()):
        jlearner = JL(None, JHelper())
        jstate, _, _ = jlearner.init_state()
        params0 = jax.tree_util.tree_map(np.array, jax.device_get(jstate.params))
        paths = [p for p in _flat(params0) if p.endswith('kernel')]
        rg, ft, _ = JPR(jlearner)._build_rollout_programs(jstate.params, jstate.batch_stats, paths)
        ratios = jnp.asarray([0.3, 0.5, 0.7, 0.4], jnp.float32)
        pruned, masks, opt_rg = rg['init'](jstate.params, ratios)
        pruned0 = jax.tree_util.tree_map(np.array, jax.device_get(pruned))
        masks_np = {k: v for k, v in _flat(jax.device_get(masks)).items()}
        images, labels = jlearner.dataset_train.synthesize_arrays(64)
        batch = {'image': images[:BATCH], 'label': labels[:BATCH]}
        rng = np.random.default_rng(0)

        def perturbed(tree):
            return jax.tree_util.tree_map(lambda a: (a * (1 + PERTURBATION * rng.standard_normal(
                a.shape))).astype(np.float32), tree)

        def noisy_images():
            image = batch['image'].astype(np.float32)
            return dict(batch, image=image * (1 + PERTURBATION * rng.standard_normal(image.shape)))

        def jax_rg(start, b):
            new, _ = rg['step'](jstate.params, jstate.batch_stats,
                                jax.tree_util.tree_map(jnp.asarray, start), masks,
                                opt_rg, jax.tree_util.tree_map(jnp.asarray, b))
            return _flat(jax.device_get(new))

        def jax_ft(start, b):
            start = jax.tree_util.tree_map(jnp.asarray, start)
            new, _, _ = ft['step'](start, jstate.batch_stats, masks, ft['init'](start),
                                   jax.tree_util.tree_map(jnp.asarray, b))
            return _flat(jax.device_get(new))

        for name, step in (('regression', jax_rg), ('finetune', jax_ft)):
            out[name] = {'start': _flat(pruned0), 'masks': masks_np,
                         'jax': step(pruned0, batch),
                         'reruns': [step(pruned0, noisy_images()), step(perturbed(pruned0), batch)]}

        tlearner = _port_learner(tmp_path)
        full = tlearner.init_state()[0].model
        load_jax_numpy(full, params0, {})
        tmasks = {k.replace('/', '.'): torch.from_numpy(v) for k, v in masks_np.items()}
        tbatch = tlearner.put_batch(batch)
        for name in ('regression', 'finetune'):
            pruned_model = tlearner.init_state()[0].model
            load_jax_numpy(pruned_model, pruned0, {})
            if name == 'regression':
                tpr.regression_step(tlearner, full, pruned_model, tmasks,
                                    tpr.regression_optimizer(pruned_model), tbatch)
            else:
                tpr.finetune_step(tlearner, pruned_model, tmasks,
                                  tpr.finetune_optimizer(pruned_model), tbatch)
            out[name]['port'] = {k.replace('.', '/'): v.detach().numpy().copy()
                                 for k, v in pruned_model.named_parameters()}
            out[name]['full_after'] = {k: v.clone() for k, v in full.state_dict().items()}
        out['params0'] = _flat(params0)
    mesh_lib.reset_global_mesh()
    return out


@pytest.mark.parametrize('program', ['regression', 'finetune'])
def test_rollout_step_matches_jax(rollout_steps, program):
    run = rollout_steps[program]
    want, got = run['jax'], run['port']
    assert set(got) == set(want)
    moved = 0
    for key in want:
        floor = max(float(np.linalg.norm(r[key] - want[key])) for r in run['reruns'])
        bound = _tolerance(want[key], floor)
        err = float(np.linalg.norm(got[key] - want[key]))
        assert err <= bound, (program, key, err, bound)
        moved += float(np.linalg.norm(want[key] - run['start'][key])) > bound
        mask = run['masks'][key]
        if mask.ndim:  # pruned weights stay exactly zero in both packages
            assert not np.any(got[key][mask == 0]) and not np.any(want[key][mask == 0])
    # the regression trains only the four kernels; the finetune all eight
    assert moved >= {'regression': 4, 'finetune': 8}[program] * 0.9, (program, moved)


def test_rollout_steps_leave_the_full_model_alone(rollout_steps):
    params0 = rollout_steps['params0']
    for name in ('regression', 'finetune'):
        for key, value in rollout_steps[name]['full_after'].items():
            np.testing.assert_array_equal(value.numpy(), params0[key.replace('.', '/')])


# ---------------------------------------------------------------------------
# the optimal search, the uniform protocol, main.main
# ---------------------------------------------------------------------------

SEARCH = dict(ws_prune_ratio_prtl='optimal', ws_nb_rlouts=2, ws_nb_rlouts_min=1,
              ws_nb_iters_rg=2, ws_nb_iters_ft=2, ws_nb_iters_feval=2)


def test_full_model_unchanged_after_two_rollouts(tmp_path):
    from pocketflow_tpu_torch.learners.weight_sparsification.pr_optimizer import PROptimizer
    learner = _port_learner(tmp_path, **SEARCH)
    model = learner.init_state()[0].model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    PROptimizer(learner).run(model)
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_optimal_search_meets_the_budget_and_resumes(tmp_path):
    from pocketflow_tpu_torch.learners.weight_sparsification.pr_optimizer import PROptimizer
    learner = _port_learner(tmp_path, **SEARCH)
    model = learner.init_state()[0].model
    pairs = PROptimizer(learner).run(model)
    assert [p for p, _ in pairs] == ['conv1.kernel', 'conv2.kernel', 'fc3.kernel', 'fc4.kernel']
    ratios = np.array([r for _, r in pairs])
    assert np.all(ratios >= 0.0) and np.all(ratios <= 1.0)
    shapes = [(3, 3, 1, 32), (3, 3, 32, 64), (3136, 1024), (1024, 10)]
    nb = np.array([np.prod(s) for s in shapes], np.float64)
    assert np.sum(nb * ratios) / np.sum(nb) >= 0.5 - 0.01
    search = np.load(tmp_path / 'ws' / 'ddpg_search.npz')
    assert int(search['x_idx_rlout']) == 1
    # a third roll-out resumes after the two saved ones
    with TFLAGS.scope(ws_nb_rlouts=3):
        resumed = PROptimizer(learner).run(model)
    assert int(np.load(tmp_path / 'ws' / 'ddpg_search.npz')['x_idx_rlout']) == 2
    assert len(resumed) == 4


def test_weight_sparse_uniform_end_to_end(tmp_path):
    from pocketflow_tpu_torch.learners.weight_sparsification import masking
    learner = _port_learner(tmp_path, batch_size=16, nb_smpls_train=480, nb_smpls_eval=128,
                            batch_size_eval=32, nb_epochs_rat=0.03, lrn_rate_init=0.05,
                            ws_prune_ratio=0.5, ws_prune_ratio_prtl='uniform',
                            ws_mask_update_step=5, ws_iter_ratio_beg=0.1, ws_iter_ratio_end=0.5)
    state = learner.train()
    params = dict(state.model.named_parameters())
    pr_msk = float(masking.calc_prune_ratio(params, maskable_only=True))
    assert pr_msk == pytest.approx(0.5, abs=0.02), pr_msk
    for name, mask in state.extra['masks'].items():
        if masking.is_maskable_path(name):
            assert not torch.any(params[name].detach()[mask == 0]), name
    metrics = learner.evaluate()
    assert np.isfinite(metrics['loss'])
    assert metrics['pr_msk'] == pytest.approx(0.5, abs=0.02)


@pytest.mark.parametrize('protocol', ['uniform', 'heurist', 'optimal'])
def test_main_runs_weight_sparse(tmp_path, protocol):
    """python -m pocketflow_tpu_torch.main --learner=weight-sparse, from a
    full-prec baseline, then --exec_mode=eval."""
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.learners.weight_sparsification.learner import WeightSparseLearner
    if 'model' in TFLAGS:
        TFLAGS.model = TFLAGS._specs['model'].default
    argv = ['--synthetic_data', '--nb_smpls_train=32', '--nb_smpls_eval=16', '--batch_size=8',
            '--batch_size_eval=8', '--compute_dtype=float32', '--summ_step=1',
            '--log_dir=%s' % (tmp_path / 'logs'),
            '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt'),
            '--ws_save_path=%s' % (tmp_path / 'ws' / 'model.ckpt')]
    port_main.main(argv + ['--nb_epochs_rat=0.01'], device='cpu')
    ws = argv + ['--learner=weight-sparse', '--ws_prune_ratio_prtl=%s' % protocol,
                 '--ws_prune_ratio=0.5', '--nb_epochs_rat=0.05', '--ws_mask_update_step=2',
                 '--ws_iter_ratio_end=0.3', '--ws_nb_rlouts=2', '--ws_nb_rlouts_min=1',
                 '--ws_nb_iters_rg=1', '--ws_nb_iters_ft=1', '--ws_nb_iters_feval=1']
    learner = port_main.main(ws, device='cpu')
    assert isinstance(learner, WeightSparseLearner)
    assert len(learner.var_names_n_prune_ratios) == 4
    metrics = port_main.main(ws + ['--exec_mode=eval'], device='cpu').evaluate()
    ratios = np.array([r for _, r in learner.var_names_n_prune_ratios])
    nb = np.array([288, 18432, 3211264, 10240], np.float64)
    assert metrics['pr_msk'] == pytest.approx(np.sum(nb * ratios) / np.sum(nb), abs=0.02)
