"""Parity of the port's weight-sparsification masks
(pocketflow_tpu_torch/learners/weight_sparsification/masking.py) with the
JAX package's masking.py, and of bench.py's composed pruned+QAT train step
(channel masks, masked gradients, the masks re-applied after each update) in
both packages.

Inputs are made with numpy from a seed and handed to both packages.  The
parameter trees are nested dicts on the JAX side and dicts keyed by the
port's dotted names ('a.b.kernel') on the port's.  Tolerances: none for the
masks, the bisection thresholds and every product with a 0/1 mask, which
both packages compute with the same fp32 operations in the same order;
rtol 1e-6 for the pruning schedule (a power of an fp32 base, whose last bit
the two libraries may round differently).  The composed steps are held to
tests/torch_slice_parity.py's per-tensor bounds (its docstring gives them
and their reasons), and the masked channels must be exactly zero after each
step in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.learners.weight_sparsification import masking as jm
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.learners.weight_sparsification import masking as tm
from torch_slice_parity import (  # noqa: F401  (collected here)
    _run, test_batch_stats_after_two_steps_match, test_params_after_two_steps_match,
    test_train_loss_and_metrics_match, test_two_steps_move_parameters_past_the_tolerance,
    test_update_has_the_reference_size)

torch.set_num_threads(2)

# (path, shape): conv, dense, BN and depthwise leaves, one kernel large
# enough for the bisection branch (>= 65536 elements) and several below it
TREE = [(('conv1', 'kernel'), (3, 3, 3, 16)),
        (('bn1', 'bn', 'scale'), (16,)),
        (('bn1', 'bn', 'bias'), (16,)),
        (('dw1', 'kernel'), (3, 3, 1, 16)),
        (('stage1_block0', 'conv1', 'kernel'), (3, 3, 64, 128)),
        (('stage1_block0', 'conv2', 'kernel'), (1, 1, 128, 32)),
        (('dense', 'kernel'), (32, 10)),
        (('dense', 'bias'), (10,))]


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _trees(seed=0):
    """(JAX nested dict, port dict by dotted name) of the same numpy values."""
    rng = np.random.default_rng(seed)
    jtree, ttree = {}, {}
    for path, shape in TREE:
        value = rng.standard_normal(shape).astype(np.float32)
        node = jtree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(value)
        ttree['.'.join(path)] = torch.from_numpy(value.copy())
    return jtree, ttree


def _flat_jax(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat_jax(value, prefix + (key,)))
        else:
            out['.'.join(prefix + (key,))] = np.asarray(value)
    return out


def _assert_trees_equal(jtree, ttree):
    jflat = _flat_jax(jtree)
    assert list(jflat) == list(ttree)  # the same names in the same (tree) order
    for name, value in jflat.items():
        np.testing.assert_array_equal(ttree[name].numpy(), value, err_msg=name)


@pytest.mark.parametrize('path', [('conv1', 'kernel'), ('dw1', 'kernel'), ('dwx', 'b', 'kernel'),
                                  ('dense', 'bias'), ('bn', 'scale'), ('a', 'dw', 'kernel'),
                                  ('kernel',), ('stage1_block0', 'conv1', 'kernel')])
def test_paths_match(path):
    assert tm.path_str(path) == jm.path_str(path).replace('/', '.')
    assert tm.path_str(tm.path_str(path)) == tm.path_str(path)
    assert tm.is_maskable_path(path) == jm.is_maskable_path(path)
    assert tm.is_maskable_path(tm.path_str(path)) == jm.is_maskable_path(path)


def test_maskable_paths_shapes_and_mask_state_match():
    jtree, ttree = _trees()
    assert tm.maskable_paths(ttree) == [p.replace('/', '.') for p in jm.maskable_paths(jtree)]
    assert tm.maskable_shapes(ttree) == [tuple(s) for s in jm.maskable_shapes(jtree)]
    jstate, tstate = jm.build_mask_state(jtree), tm.build_mask_state(ttree)
    for key in ('masks', 'bkups'):
        _assert_trees_equal(jstate[key], tstate[key])


@pytest.mark.parametrize('exp,beg,end', [(3.0, 0.1, 0.5), (1.0, 0.0, 1.0), (2.0, 0.3, 0.3)])
def test_dynamic_prune_ratio_matches(exp, beg, end):
    flags = dict(ws_prune_ratio_exp=exp, ws_iter_ratio_beg=beg, ws_iter_ratio_end=end)
    with JFLAGS.scope(**flags), TFLAGS.scope(**flags):
        for step in (0, 5, 10, 11, 30, 49, 50, 99, 1000):
            want = jm.dynamic_prune_ratio(jnp.asarray(step, jnp.int32), 100, 0.75)
            got = tm.dynamic_prune_ratio(torch.tensor(step), 100, 0.75)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize('ratio', [0.0, 0.1, 0.5, 0.9, 1.0, 1.5])
def test_bisection_threshold_is_bit_equal(ratio):
    mag = np.abs(np.random.default_rng(1).standard_normal(70000)).astype(np.float32)
    want = jm.percentile_threshold_bisect(jnp.asarray(mag), jnp.float32(ratio))
    got = tm.percentile_threshold_bisect(torch.from_numpy(mag), ratio)
    assert got.dtype == torch.float32
    assert float(got) == float(want)


@pytest.mark.parametrize('size', [1 << 16, 3000])  # bisection, torch.quantile
@pytest.mark.parametrize('ratio', [0.3, 0.5, 0.0, -0.1])
def test_percentile_mask_matches_both_branches(size, ratio):
    w = np.random.default_rng(size).standard_normal(size).astype(np.float32).reshape(-1, 8)
    want = np.asarray(jm.percentile_mask(jnp.asarray(w), jnp.float32(ratio)))
    got = tm.percentile_mask(torch.from_numpy(w), ratio)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if ratio <= 0:
        assert want.min() == 1.0  # a ratio <= 0 keeps everything
    else:
        assert abs(1 - want.mean() - ratio) < 0.01


def test_prune_update_matches_over_a_tree():
    """Two prune steps in a row (the second refreshes the backups of the
    weights the first kept), at a ramping dynamic ratio."""
    jtree, ttree = _trees(2)
    ratios = {name: r for name, r in zip(tm.maskable_paths(ttree), (0.5, 0.8, 0.25, 0.6))}
    jratios = {name.replace('.', '/'): r for name, r in ratios.items()}
    jextra, textra = jm.build_mask_state(jtree), tm.build_mask_state(ttree)
    for step in (30, 60):
        jtree, jextra = jm.prune_update(jtree, jextra, jnp.asarray(step), 100, jratios)
        ttree, textra = tm.prune_update(ttree, textra, torch.tensor(step), 100, ratios)
        _assert_trees_equal(jtree, ttree)
        for key in ('masks', 'bkups'):
            _assert_trees_equal(jextra[key], textra[key])
    # at step 60 the schedule has reached the final ratios
    sizes = {name: ttree[name].numel() for name in ratios}
    want = sum(ratios[n] * sizes[n] for n in ratios) / sum(sizes.values())
    assert abs(float(tm.calc_prune_ratio(ttree, maskable_only=True)) - want) < 0.01


def _channel_masks(ttree, seed):
    """[1, 1, c, 1] masks on the 4-D kernels, as bench.py builds them."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in ttree.items():
        if p.dim() == 4:
            out[name] = (rng.random((1, 1, p.shape[2], 1)) > 0.5).astype(np.float32)
        else:
            out[name] = np.ones((), np.float32)
    return out


@pytest.mark.parametrize('full_masks', [False, True])
def test_mask_gradients_and_apply_masks_match(full_masks):
    jtree, ttree = _trees(3)
    if full_masks:
        masks = {name: (np.random.default_rng(4).random(tuple(p.shape)) > 0.3).astype(np.float32)
                 for name, p in ttree.items()}
    else:
        masks = _channel_masks(ttree, 4)
    jmasks = {}
    for name, m in masks.items():
        node = jmasks
        parts = name.split('.')
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = jnp.asarray(m)
    tmasks = {name: torch.from_numpy(m) for name, m in masks.items()}
    for jfn, tfn, tfn_ in ((jm.mask_gradients, tm.mask_gradients, tm.mask_gradients_),
                           (jm.apply_masks, tm.apply_masks, tm.apply_masks_)):
        want = jfn(jtree, jmasks)
        got = tfn(ttree, tmasks)
        _assert_trees_equal(want, got)
        inplace = {name: p.clone() for name, p in ttree.items()}
        tfn_(inplace, tmasks)
        for name in ttree:
            assert torch.equal(inplace[name], got[name]), name
    grads = {name: None for name in ttree}
    tm.mask_gradients_(grads, tmasks)  # parameters without a gradient are skipped


def test_masks_from_ratios_and_prune_ratio_match():
    jtree, ttree = _trees(5)
    ratios = {name: r for name, r in zip(tm.maskable_paths(ttree), (0.0, 0.7, 0.5, 0.9))}
    jmasks = jm.masks_from_ratios(jtree, {n.replace('.', '/'): r for n, r in ratios.items()})
    tmasks = tm.masks_from_ratios(ttree, ratios)
    _assert_trees_equal(jmasks, tmasks)
    jpruned, tpruned = jm.apply_masks(jtree, jmasks), tm.apply_masks(ttree, tmasks)
    for maskable_only in (False, True):
        want = float(jm.calc_prune_ratio(jpruned, maskable_only))
        got = tm.calc_prune_ratio(tpruned, maskable_only)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_masking_flags_match_the_jax_registry():
    import pocketflow_tpu.learners.weight_sparsification.pr_optimizer  # noqa: F401
    for name in ('ws_prune_ratio_exp', 'ws_iter_ratio_beg', 'ws_iter_ratio_end'):
        assert TFLAGS.defaults()[name] == JFLAGS._specs[name].default


# ---------------------------------------------------------------------------
# bench.py's composed pruned+QAT step, two steps against the JAX step
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def run():
    return _run(buckets=False, composed=True)


def test_port_builds_the_bench_masks(run):
    """weight_sparsification.pruned_qat.channel_masks draws bench.py's masks from the same
    seed: the port walks its parameters in the JAX package's tree order."""
    port, numpy_masks = run['port_channel_masks'], run['numpy_masks']
    assert set(port) == set(numpy_masks)
    for name, mask in numpy_masks.items():
        np.testing.assert_array_equal(port[name], mask, err_msg=name)
    assert len(run['masks']) == 52  # every conv kernel but the 12-channel s2d stem


def test_masked_channels_stay_zero(run):
    """After each step the masked input channels of every masked kernel are
    exactly zero in both packages, and the steps moved the channels kept."""
    for index, step in enumerate(run['steps']):
        for source in ('jax', 'port'):
            after = step[source][1]
            for key, mask in run['masks'].items():
                dead = after[key] * (1.0 - mask)
                assert not dead.any(), (index, source, key)
                kept = (after[key] - step['start'][key]) * mask
                assert kept.any(), (index, source, key)


def test_masked_gradients_leave_no_momentum(run):
    """The gradients were masked before the update: the SGD momentum of the
    masked channels is exactly zero after each step (the re-zero of the
    parameters alone would hide an unmasked gradient there), and that of
    the kept channels is not (the parameters, which the update moves by
    the momentum, are held to the JAX step above)."""
    for index, step in enumerate(run['steps']):
        momentum = step['momentum']
        assert set(momentum['port']) == set(momentum['jax']) == set(run['masks'])
        for key, mask in run['masks'].items():
            for source in ('jax', 'port'):
                assert not (momentum[source][key] * (1.0 - mask)).any(), (index, source, key)
            assert (momentum['port'][key] * mask).any(), (index, key)
