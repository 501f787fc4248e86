"""The port's other channel-pruning learners against the JAX package's, on
the CPU in fp32: chn-pruned-rmt (channel_pruning_rmt), chn-pruned-gpu
(channel_pruning_gpu) and dis-chn-pruned (discr_channel_pruning).

* meta-LASSO and meta-least-squares against make_meta_lasso/make_meta_lstsq
  (optax.adam): within 1e-5 of the largest coefficient (+1e-6);
* channel_norms and group_lasso_shrink within 1e-6 relative; percentile 0
  leaves the kernel as it is, and a shrink without that guard (planted
  fault) zeroes its weakest channel;
* one CPG PGD step (from a copy 10% off the full model) and one
  reconstruction step of ResNet-20 (the relative Adam) against the JAX
  programs from one bridged state, every kernel
  within tests/torch_step_parity.py's bound (rtol 1e-4, atol 1e-5 on the L2
  norm, plus 2x the spread of JAX reruns with perturbed inputs, parameters
  or batch order), the losses too;
* AuxHead against the Flax module, its parameters carried across by
  core/bridge.py:aux_heads_from_jax, within 1e-5;
* one DCP grad-norm (within 1e-4 relative), block-FT and layer-FT step of
  ConvNet against the JAX programs from one bridged state (masks, heads,
  parameters), within the same bound; merge_bkup equal, and a backup
  refreshed under the new mask (planted fault) restarts a re-added channel
  at 0;
* ConvNet @ FMNIST end to end at the JAX tests' sizes and invariants (CPG:
  >= 40% of conv2's channels zeroed; DCP and CPR: exactly 16 of 32) and
  main.main with each learner (CPR with --enbl_dst), then --exec_mode=eval.
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
from pocketflow_tpu_torch.core.bridge import aux_heads_from_jax, load_jax_numpy
from torch_slice_parity import _flat
from torch_step_parity import jax_runs, out_of_bound

torch.set_num_threads(2)
SMALL = dict(synthetic_data=True, compute_dtype='float32', rand_seed=0, batch_size=8,
             batch_size_eval=8, nb_smpls_train=64, nb_smpls_eval=16)


@pytest.fixture(autouse=True)
def _port_flags(monkeypatch):
    """Restore the port's flags after each test; the JSONL summaries spare
    the tests TensorBoard's imports."""
    import pocketflow_tpu_torch.learners.channel_pruning_gpu.learner  # noqa: F401  (cpg_*)
    import pocketflow_tpu_torch.learners.channel_pruning_rmt.learner  # noqa: F401  (cpr_*)
    import pocketflow_tpu_torch.learners.discr_channel_pruning.learner  # noqa: F401  (dcp_*)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _jax_mesh():
    mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:1], ('data',), (1,)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


# ---------------------------------------------------------------------------
# CPR solvers
# ---------------------------------------------------------------------------

def test_meta_lasso_and_lstsq_match_jax():
    from pocketflow_tpu.learners.channel_pruning_rmt import learner as jrmt
    from pocketflow_tpu_torch.learners.channel_pruning import channel_pruner as tcp
    from pocketflow_tpu_torch.learners.channel_pruning_rmt import learner as trmt
    rng = np.random.default_rng(0)
    P = rng.normal(size=(240, 24)).astype(np.float32)
    y = (P[:, :6] @ rng.normal(size=6) + 0.1 * rng.normal(size=240)).astype(np.float32)
    want = np.asarray(jrmt.make_meta_lasso(100, 1e-2)(jnp.asarray(P), jnp.asarray(y),
                                                       jnp.float32(1e-3)))
    got = trmt.make_meta_lasso(100, 1e-2)(tcp.lasso_problem(torch.from_numpy(P),
                                                            torch.from_numpy(y)),
                                          P.shape[0], 1e-3).numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want)) + 1e-6
    np.testing.assert_array_equal(np.argsort(-np.abs(got))[:12], np.argsort(-np.abs(want))[:12])

    X = rng.normal(size=(300, 18)).astype(np.float32)
    W_true = rng.normal(size=(18, 5)).astype(np.float32)
    Y = (X @ W_true + 0.05 * rng.normal(size=(300, 5))).astype(np.float32)
    W0 = (W_true + 0.3 * rng.normal(size=W_true.shape)).astype(np.float32)
    want = np.asarray(jrmt.make_meta_lstsq(100, 1e-2)(jnp.asarray(X), jnp.asarray(Y),
                                                       jnp.asarray(W0)))
    got = trmt.make_meta_lstsq(100, 1e-2)(torch.from_numpy(X), torch.from_numpy(Y),
                                          torch.from_numpy(W0)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want)) + 1e-6
    assert np.linalg.norm(got - W0) > 0.1  # the solver moved


# ---------------------------------------------------------------------------
# CPG: the shrinkage, one PGD and one reconstruction step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('percentile', [0.0, 30.0, 50.0, 87.5, 100.0])
def test_group_lasso_shrink_matches_jax(percentile):
    from pocketflow_tpu.learners.channel_pruning_gpu import learner as jcpg
    from pocketflow_tpu_torch.learners.channel_pruning_gpu import learner as tcpg
    k = np.random.default_rng(1).normal(size=(3, 3, 12, 8)).astype(np.float32)
    k *= np.linspace(0.1, 2.0, 12, dtype=np.float32)[None, None, :, None]
    np.testing.assert_allclose(tcpg.channel_norms(torch.from_numpy(k)).numpy(),
                               np.asarray(jcpg.channel_norms(jnp.asarray(k))), rtol=1e-6)
    want = np.asarray(jcpg.group_lasso_shrink(jnp.asarray(k), jnp.float32(percentile)))
    got = tcpg.group_lasso_shrink(torch.from_numpy(k), torch.tensor(percentile)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the linear quantile at q sits at sorted position 11 q: every channel up
    # to it is zeroed; percentile 0 is a no-op
    zeroed = np.linalg.norm(got.transpose(2, 0, 1, 3).reshape(12, -1), axis=1) == 0
    want_zeroed = 0 if percentile == 0 else int(np.floor(percentile / 100 * 11)) + 1
    assert zeroed.sum() == want_zeroed
    if percentile == 0.0:
        np.testing.assert_array_equal(got, k)


def test_group_lasso_shrink_without_the_percentile_zero_guard_fails():
    """Planted fault: thr = quantile(norms, 0) = the smallest norm zeroes the
    weakest channel of a skipped (percentile 0) layer."""
    from pocketflow_tpu_torch.learners.channel_pruning_gpu import learner as tcpg
    k = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 3, 6, 4)).astype(np.float32))

    def unguarded(kernel, percentile):
        norms = tcpg.channel_norms(kernel)
        thr = torch.quantile(norms.reshape(-1), torch.tensor(percentile / 100.0))
        return kernel * torch.clamp_min(1.0 - thr / norms, 0.0)

    assert torch.equal(tcpg.group_lasso_shrink(k, 0.0), k)
    assert not torch.equal(unguarded(k, 0.0), k)
    assert int((tcpg.channel_norms(unguarded(k, 0.0)) == 0).sum()) == 1


@pytest.fixture(scope='module')
def cpg_steps():
    """One PGD step and one reconstruction step of ResNet-20 (batch 8) in both
    packages from one bridged state, with the JAX reruns."""
    from pocketflow_tpu.learners.channel_pruning_gpu.learner import ChannelPrunedGpuLearner as JL
    from pocketflow_tpu.nets.resnet_at_cifar10 import ModelHelper as JH
    from pocketflow_tpu_torch.learners.channel_pruning_gpu import learner as tcpg
    from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper as TH
    _jax_mesh()
    out = {}
    with JFLAGS.scope(**SMALL, cpg_lrn_rate_adam=1e-2), \
            TFLAGS.scope(**TFLAGS.as_dict()):
        TFLAGS.override(**SMALL, cpg_lrn_rate_adam=1e-2)
        jl = JL(None, JH())
        jstate, _, _ = jl.init_state()
        params0, bstats = _np_tree(jstate.params), _np_tree(jstate.batch_stats)
        jpaths = jl.prunable_paths(jstate.params)
        pgd, masks_of, recon_init, recon_step = jl._build_channel_select_programs(jpaths)
        images, labels = jl.dataset_train.synthesize_arrays(64)
        images, labels = images[:8].astype(np.float32), labels[:8]
        nb = len(jpaths)
        # the PGD step starts 10% off the full model: at the full model
        # itself the regression gradient is exactly 0 and only the shrink acts
        noise = np.random.default_rng(9)
        pstart = jax.tree_util.tree_map(lambda a: (a * (1 + 0.1 * noise.standard_normal(
            a.shape))).astype(np.float32), params0)
        lrn = np.full(nb, 0.05, np.float32)
        pct = np.linspace(10.0, 60.0, nb).astype(np.float32)
        pruned1, _ = pgd(params0, bstats, pstart, jnp.asarray(lrn), jnp.asarray(pct),
                         {'image': jnp.asarray(images), 'label': jnp.asarray(labels)})
        masks = _np_tree(masks_of(pruned1))
        start = _np_tree(jax.jit(lambda p, m: jax.tree_util.tree_map_with_path(
            lambda path, a, mm: a * mm if a.ndim == 4 else a, p, m))(params0, masks))

        def jax_pgd(snapshot, imgs, lbls):
            new, losses = pgd(params0, bstats, snapshot['params'], jnp.asarray(lrn),
                              jnp.asarray(pct), {'image': jnp.asarray(imgs),
                                                 'label': jnp.asarray(lbls)})
            return {**{k: v for k, v in _flat(_np_tree(new)).items() if k in kernels},
                    'losses': np.asarray(losses)}

        def jax_recon(snapshot, imgs, lbls):
            new, _, losses = recon_step(params0, bstats, snapshot['params'], masks,
                                        recon_init(snapshot['params']),
                                        {'image': jnp.asarray(imgs),
                                         'label': jnp.asarray(lbls)})
            return {**{k: v for k, v in _flat(_np_tree(new)).items() if k in kernels},
                    'losses': np.asarray(losses)}

        kernels = set(jpaths)
        for name, step, snap in (('pgd', jax_pgd, pstart), ('recon', jax_recon, start)):
            want, reruns = jax_runs(step, {'params': snap}, images, labels)
            out[name] = {'jax': want, 'reruns': reruns}

        tl = tcpg.ChannelPrunedGpuLearner(None, TH(), device='cpu')
        full = tl.init_state()[0].model
        load_jax_numpy(full, params0, bstats)
        names = tl.prunable_paths(dict(full.named_parameters()))
        assert names == [p.replace('/', '.') for p in jpaths]
        batch = {'image': torch.from_numpy(images), 'label': torch.from_numpy(labels)}
        for name in ('pgd', 'recon'):
            pruned = tl.init_state()[0].model
            load_jax_numpy(pruned, pstart if name == 'pgd' else start, bstats)
            if name == 'pgd':
                losses = tcpg.pgd_step(tl, full, pruned, names, torch.from_numpy(lrn),
                                       torch.from_numpy(pct), batch)
            else:
                tmasks = {k.replace('/', '.'): torch.from_numpy(v)
                          for k, v in _flat(masks).items()}
                params = dict(pruned.named_parameters())
                opt = tcpg.RelativeAdam([params[n] for n in names], 1e-2)
                losses = tcpg.recon_step(tl, full, pruned, names, tmasks, opt, batch)
            got = {k.replace('.', '/'): v.detach().numpy() for k, v in pruned.named_parameters()
                   if k in names}
            out[name]['port'] = {**got, 'losses': losses.numpy()}
            out[name]['start'] = {k: v for k, v in _flat(pstart if name == 'pgd' else start)
                                  .items() if k in kernels}
        out['masks'] = masks
    mesh_lib.reset_global_mesh()
    return out


@pytest.mark.parametrize('program', ['pgd', 'recon'])
def test_cpg_step_matches_jax(cpg_steps, program):
    run = cpg_steps[program]
    assert out_of_bound(run['jax'], run['reruns'], run['port']) == []
    moved = sum(float(np.linalg.norm(run['jax'][k] - v)) > 1e-3 * float(np.linalg.norm(v))
                for k, v in run['start'].items())
    assert moved >= 0.9 * len(run['start'])
    if program == 'pgd':  # the shrinkage zeroed channels in both
        assert any(np.any(m == 0) for m in _flat(cpg_steps['masks']).values())


# ---------------------------------------------------------------------------
# DCP: AuxHead, the three programs, merge_bkup
# ---------------------------------------------------------------------------

def test_aux_head_matches_flax():
    from pocketflow_tpu.learners.discr_channel_pruning.learner import AuxHead as J
    from pocketflow_tpu_torch.learners.discr_channel_pruning.learner import AuxHead as T
    x = np.random.default_rng(3).normal(size=(4, 7, 7, 16)).astype(np.float32) * 2 + 0.5
    params = J(nb_classes=10).init(jax.random.PRNGKey(1), jnp.asarray(x))['params']
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * np.random.default_rng(4).normal(size=a.shape)
        .astype(np.float32), jax.device_get(params))
    want = np.asarray(J(nb_classes=10).apply({'params': params}, jnp.asarray(x)))
    head = T(16, 10)
    aux_heads_from_jax({'site': head}, {'site': params})
    got = head(torch.from_numpy(x.transpose(0, 3, 1, 2))).detach().numpy()
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(KeyError):
        aux_heads_from_jax({'site': head}, {'other': params})


DCP_FLAGS = dict(SMALL, dcp_nb_stages=1, dcp_lrn_rate_adam=1e-3)


@pytest.fixture(scope='module')
def dcp_steps():
    """The DCP programs on ConvNet @ FMNIST from one bridged state: conv2's
    second half masked, the heads from the JAX init; block FT (block 0, then
    the last block), grad norms and layer FT of conv2, with the JAX reruns."""
    from pocketflow_tpu.learners.discr_channel_pruning.learner import DisChnPrunedLearner as JL
    from pocketflow_tpu.nets.convnet_at_fmnist import ModelHelper as JH
    from pocketflow_tpu_torch.learners.channel_pruning.learner import kernel_masks
    from pocketflow_tpu_torch.learners.discr_channel_pruning import learner as tdcp
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper as TH
    _jax_mesh()
    out = {}
    with JFLAGS.scope(**DCP_FLAGS), TFLAGS.scope(**TFLAGS.as_dict()):
        TFLAGS.override(**DCP_FLAGS)
        jl = JL(None, JH())
        jstate, _, _ = jl.init_state()
        params0, bstats = _np_tree(jstate.params), _np_tree(jstate.batch_stats)
        images, labels = jl.dataset_train.synthesize_arrays(64)
        batch = {'image': images[:8], 'label': labels[:8]}
        sample = jnp.asarray(images[:2].astype(np.float32) / 255.0)
        conv_paths, layer_to_block, head_sites = jl.discover_structure(
            jstate.params, jstate.batch_stats, sample)
        assert (conv_paths, layer_to_block, head_sites) == (['conv1', 'conv2'], [0, 0], ['conv2'])
        progs = jl._build_programs(conv_paths, head_sites)
        aux = _np_tree(progs['init_aux'](params0, bstats, batch, jax.random.PRNGKey(3)))
        chn = np.ones(32, np.float32)
        chn[16:] = 0.0
        masks = jax.tree_util.tree_map_with_path(
            lambda path, a: chn.reshape(1, 1, -1, 1) if path[0].key == 'conv2'
            and path[-1].key == 'kernel' else np.ones((), np.float32), params0)
        start = jax.tree_util.tree_map(lambda a, m: a * m, params0, masks)
        layer_onehot = jnp.asarray([0.0, 1.0])
        fbatch = lambda imgs, lbls: {'image': jnp.asarray(imgs),  # noqa: E731
                                     'label': jnp.asarray(lbls)}

        def block_ft(idx_block):
            onehot = jnp.zeros(2).at[idx_block].set(1.0)

            def step(snapshot, imgs, lbls):
                p = snapshot['params']
                new_p, new_a, _ = progs['block_ft'](params0, bstats, p, aux, masks,
                                                    progs['opt_init'](p, aux),
                                                    fbatch(imgs, lbls), onehot)
                return {**_flat(_np_tree(new_p)),
                        **{'aux/' + k: v for k, v in _flat(_np_tree(new_a)).items()}}
            return step

        def layer_ft(snapshot, imgs, lbls):
            p = snapshot['params']
            new_p, _ = progs['layer_ft'](params0, bstats, p, aux, masks,
                                         progs['layer_opt_init'](p), fbatch(imgs, lbls),
                                         layer_onehot, jnp.asarray([1.0, 0.0]))
            return _flat(_np_tree(new_p))

        images8 = images[:8].astype(np.float32)
        for name, step in (('block0', block_ft(0)), ('block1', block_ft(1)),
                           ('layer', layer_ft)):
            want, reruns = jax_runs(step, {'params': start}, images8, labels[:8])
            out[name] = {'jax': want, 'reruns': reruns, 'start': _flat(start)}
        out['norms'] = {'jax': np.asarray(progs['grad_norm'](
            params0, bstats, start, aux, fbatch(images8, labels[:8]), layer_onehot,
            jnp.asarray([1.0, 0.0])))}

        tl = tdcp.DisChnPrunedLearner(None, TH(), device='cpu')
        full = tl.init_state()[0].model
        load_jax_numpy(full, params0, bstats)
        tbatch = {'image': torch.from_numpy(images8), 'label': torch.from_numpy(labels[:8])}

        def port_setup():
            model = tl.init_state()[0].model
            load_jax_numpy(model, start, bstats)
            heads = {'conv2': tdcp.AuxHead(64, 10)}
            aux_heads_from_jax(heads, aux)
            return model, heads, kernel_masks(model, {'conv2': torch.from_numpy(chn)})

        for name, onehot in (('block0', [1.0, 0.0]), ('block1', [0.0, 1.0])):
            model, heads, tmasks = port_setup()
            opt = torch.optim.Adam(list(model.parameters()) + list(heads['conv2'].parameters()),
                                   lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
            tdcp.block_ft_step(tl, full, model, heads, head_sites, tmasks, opt, tbatch, onehot)
            out[name]['port'] = {
                **{k.replace('.', '/'): v.detach().numpy() for k, v in model.named_parameters()},
                **{'aux/conv2/' + k.replace('.', '/'): v.detach().numpy()
                   for k, v in heads['conv2'].named_parameters()}}
        model, heads, tmasks = port_setup()
        out['norms']['port'] = tdcp.grad_norm_step(tl, full, model, heads, head_sites, tbatch,
                                                   'conv2', [1.0, 0.0]).numpy()
        kernel = dict(model.named_parameters())['conv2.kernel']
        opt = torch.optim.Adam([kernel], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
        tdcp.layer_ft_step(tl, full, model, heads, head_sites, tmasks, opt, tbatch, 'conv2',
                           [1.0, 0.0])
        out['layer']['port'] = {k.replace('.', '/'): v.detach().numpy()
                                for k, v in model.named_parameters()}
        out['jax_merge'] = progs['merge_bkup']
        out['aux_start'] = {'aux/' + k: v for k, v in _flat(aux).items()}
    mesh_lib.reset_global_mesh()
    return out


@pytest.mark.parametrize('program', ['block0', 'block1', 'layer'])
def test_dcp_step_matches_jax(dcp_steps, program):
    run = dcp_steps[program]
    assert out_of_bound(run['jax'], run['reruns'], run['port']) == []
    kernels = [k for k in run['start'] if k.endswith('kernel')]
    moved = [k for k in kernels if not np.array_equal(run['jax'][k], run['start'][k])]
    # layer FT trains conv2's kernel only; block FT every kernel
    assert moved == (['conv2/kernel'] if program == 'layer' else kernels)
    # conv2's masked channels stay zero in both
    for side in ('jax', 'port'):
        assert not np.any(run[side]['conv2/kernel'][:, :, 16:, :])
    if program != 'layer':  # the head trains in block 0; block 1 (the last) has none
        head = 'aux/conv2/fc/kernel'
        for side in ('jax', 'port'):
            assert np.array_equal(run[side][head], dcp_steps['aux_start'][head]) == (
                program == 'block1'), side


def test_dcp_grad_norms_match_jax(dcp_steps):
    want, got = dcp_steps['norms']['jax'], dcp_steps['norms']['port']
    assert got.shape == (32,) and want.shape == (32,)
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    # the pruned half keeps its gradient signal (the unmasked parameter's):
    # zero only where an input channel is dead for the whole batch, as in JAX
    np.testing.assert_array_equal(got == 0, want == 0)
    assert np.count_nonzero(got[16:]) >= 8


def _merge_case():
    rng = np.random.default_rng(6)
    p = rng.normal(size=(3, 3, 8, 4)).astype(np.float32)
    bkup = rng.normal(size=(3, 3, 8, 4)).astype(np.float32)
    old = np.ones(8, np.float32)
    old[5:] = 0.0
    new = old.copy()
    new[6] = 1.0  # channel 6 re-added
    p[:, :, 5:, :] = 0.0  # masked channels are zero in the parameter
    return p, bkup, old, new


def test_merge_bkup_matches_jax_and_restores_a_readded_channel(dcp_steps):
    from pocketflow_tpu_torch.learners.discr_channel_pruning.learner import merge_bkup
    p, bkup, old, new = _merge_case()
    tree = lambda v: {'conv': {'kernel': v}}  # noqa: E731
    mask = lambda m: {'conv': {'kernel': m.reshape(1, 1, -1, 1)}}  # noqa: E731
    jp, jb = dcp_steps['jax_merge'](tree(jnp.asarray(p)), tree(jnp.asarray(bkup)),
                                    mask(old), mask(new))
    model = torch.nn.Module()
    model.conv = torch.nn.Module()
    model.conv.kernel = torch.nn.Parameter(torch.from_numpy(p.copy()))
    tb = {'conv.kernel': torch.from_numpy(bkup.copy())}
    merge_bkup(model, tb, {'conv.kernel': torch.from_numpy(old.reshape(1, 1, -1, 1))},
               {'conv.kernel': torch.from_numpy(new.reshape(1, 1, -1, 1))})
    np.testing.assert_array_equal(model.conv.kernel.detach().numpy(), np.asarray(jp['conv']['kernel']))
    np.testing.assert_array_equal(tb['conv.kernel'].numpy(), np.asarray(jb['conv']['kernel']))
    # the re-added channel comes back with its saved weights
    np.testing.assert_array_equal(model.conv.kernel.detach().numpy()[:, :, 6], bkup[:, :, 6])

    # planted fault: the backup refreshed under the NEW mask copies the
    # channel's zeros over its saved weights, so it restarts at 0
    faulty = torch.from_numpy(bkup.copy())
    m_new = torch.from_numpy(new.reshape(1, 1, -1, 1))
    faulty = torch.where(m_new > 0.5, torch.from_numpy(p), faulty)
    assert not np.array_equal((faulty * m_new).numpy()[:, :, 6], bkup[:, :, 6])
    assert not np.any((faulty * m_new).numpy()[:, :, 6])


# ---------------------------------------------------------------------------
# end to end, main.main
# ---------------------------------------------------------------------------

E2E = dict(batch_size=16, nb_smpls_train=480, nb_smpls_eval=128, batch_size_eval=32,
           nb_epochs_rat=0.05, lrn_rate_init=0.05)


@pytest.fixture(scope='module')
def baseline(tmp_path_factory):
    """A ConvNet @ FMNIST full-prec checkpoint at the JAX tests' sizes."""
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    path = tmp_path_factory.mktemp('baseline') / 'models' / 'model.ckpt'
    with TFLAGS.scope(**TFLAGS.as_dict()):
        TFLAGS.override(**{**SMALL, **E2E}, save_path=str(path))
        FullPrecLearner(None, ModelHelper(), device='cpu').train()
    return str(path)


def _zeroed(model):
    k = dict(model.named_parameters())['conv2.kernel'].detach().numpy()
    return np.linalg.norm(k.transpose(2, 0, 1, 3).reshape(32, -1), axis=1) == 0


@pytest.mark.parametrize('learner', ['chn-pruned-gpu', 'dis-chn-pruned', 'chn-pruned-rmt'])
def test_end_to_end_at_the_jax_tests_sizes(tmp_path, baseline, learner):
    from pocketflow_tpu_torch.learners import create_learner
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    flags = {'chn-pruned-gpu': dict(cpg_prune_ratio=0.5, cpg_skip_ht_layers=False,
                                    cpg_nb_iters_layer=24),
             'dis-chn-pruned': dict(dcp_prune_ratio=0.5, dcp_nb_stages=1, dcp_nb_iters_block=6,
                                    dcp_nb_iters_layer=2),
             'chn-pruned-rmt': dict(cpr_prune_ratio=0.5, cpr_skip_frst_layer=True,
                                    cpr_nb_smpls=256, cpr_nb_crops_per_smpl=4,
                                    cpr_ista_nb_iters=50, cpr_lstsq_nb_iters=50,
                                    cp_nb_batches=3)}[learner]
    TFLAGS.override(**{**SMALL, **E2E, **flags}, save_path=baseline,
                    cpg_save_path=str(tmp_path / 'cpg' / 'model.ckpt'),
                    dcp_save_path=str(tmp_path / 'dcp' / 'model.ckpt'),
                    cpr_save_path=str(tmp_path / 'cpr' / 'model.ckpt'))
    lrn = create_learner(None, ModelHelper(), learner, device='cpu')
    state = lrn.train()
    zeroed = _zeroed(state.model)
    if learner == 'chn-pruned-gpu':
        assert zeroed.mean() >= 0.4, zeroed.mean()
        metrics = lrn.run_eval_loop(state, lrn.build_pruned_eval_step())
    else:
        assert zeroed.sum() == 16, zeroed
        metrics = lrn.run_eval_loop(state, lrn.build_eval_step())
    assert metrics['accuracy'] > 0.5
    mask = state.extra['masks']['conv2.kernel'].reshape(-1).numpy()
    np.testing.assert_array_equal(mask == 0, zeroed)
    if learner == 'dis-chn-pruned':  # the auxiliary head trained
        assert set(lrn.aux_heads) == {'conv2'}


@pytest.mark.parametrize('learner', ['chn-pruned-gpu', 'chn-pruned-rmt', 'dis-chn-pruned'])
def test_main_runs_learner(tmp_path, learner):
    """python -m pocketflow_tpu_torch.main --learner=<name> from a full-prec
    baseline (chn-pruned-rmt with --enbl_dst), then --exec_mode=eval."""
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.core import checkpoint as ckpt
    if 'model' in TFLAGS:
        TFLAGS.model = TFLAGS._specs['model'].default
    argv = ['--synthetic_data', '--nb_smpls_train=64', '--nb_smpls_eval=16', '--batch_size=8',
            '--batch_size_eval=8', '--compute_dtype=float32', '--summ_step=1',
            '--log_dir=%s' % (tmp_path / 'logs'),
            '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt')]
    port_main.main(argv + ['--nb_epochs_rat=0.01'], device='cpu')
    save = tmp_path / 'pruned' / 'model.ckpt'
    extra = {'chn-pruned-gpu': ['--cpg_nb_iters_layer=4', '--cpg_save_path=%s' % save],
             'chn-pruned-rmt': ['--enbl_dst', '--cpr_nb_smpls=16', '--cpr_nb_crops_per_smpl=4',
                                '--cpr_ista_nb_iters=20', '--cpr_lstsq_nb_iters=20',
                                '--cpr_save_path=%s' % save],
             'dis-chn-pruned': ['--dcp_nb_stages=1', '--dcp_nb_iters_block=2',
                                '--dcp_nb_iters_layer=1', '--dcp_save_path=%s' % save]}[learner]
    run = argv + ['--learner=%s' % learner, '--nb_epochs_rat=0.02'] + extra
    port_main.main(run, device='cpu')
    payload = ckpt.restore_latest(str(save))
    mask, kernel = payload['extra']['masks']['conv2.kernel'], payload['model']['conv2.kernel']
    assert mask.shape == (1, 1, 32, 1)
    if learner == 'chn-pruned-gpu':  # conv2 alone: no head or tail layer skipped
        assert 0 < int(mask.sum()) <= 16
    else:
        assert int(mask.sum()) == 16
    assert not torch.any(kernel[:, :, mask.reshape(-1) == 0, :])
    metrics = port_main.main(run + ['--exec_mode=eval'], device='cpu').evaluate()
    assert np.isfinite(metrics['loss'])
