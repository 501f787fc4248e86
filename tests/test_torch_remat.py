"""--remat_blocks on the port (nn/layers.py: maybe_remat, RematBlock), in
fp32 on the CPU.

* Gradients across the modes, port against port: ResNet-20, ResNet-18
  ImageNet with the space-to-depth stem at 32x32, MobileNet v1 and v2 at
  depth 0.25, and Faster R-CNN's resnet18 trunk, each under 'save_convs' and
  'full' against 'none' (loss: the sum of the squared outputs): the
  parameters' gradients bit-identical, every block recomputed once, and the
  BN running statistics bit-identical and moved once (equal to those of one
  no-grad train-mode forward from the same start).
* Against JAX: the port's ResNet-18 under 'save_convs' and 'full' against
  the JAX package's under 'none' (tests/test_misc_coverage.py's remat test:
  fp32, loss the sum of the squared logits, train-mode BN, bridged
  parameters), held to tests/torch_slice_parity.py's bound (rtol 1e-4, atol
  1e-5 on the norm of each gradient's difference, plus 2x the spread of JAX
  reruns with the images or the parameters perturbed by 1e-7 relative, or
  the batch reversed).  At that test's batch 2 and 32x32 the last stage's BN
  normalizes two values a channel and the JAX package's own reruns move its
  gradients by more than their norm, so no bound tells a right gradient
  from a wrong one there; at batch 4 and 64x64 the reruns move them by at
  most 1e-3 of their norm, and this test runs there.
* One train step of each learner under each mode against 'none', from the
  learner's seeded init on one batch of ResNet-20: 4-bit QAT with
  activation bits that differ from site to site (4, 6, 8, 32 in turn),
  uniform-tf with a range of its own at each site (each range recorded
  once, so update_ranges passes), non-uniform at those mixed activation
  bits, and the composed pruned+QAT step: parameters, momentum, BN
  statistics and `extra` (the EMA ranges, the codebooks) bit-equal.  The
  plain-version counter counts one grouped weight call a forward in every
  mode and one call an activation site of the forward, plus one for each
  of the 18 sites inside ResNet-20's blocks under 'save_convs' and 'full'
  (recomputed in the backward); the grouped call runs before the first
  block's region, never inside a checkpoint.
* A layerwise regression's capture forward with gradients under 'full'
  captures each layer once, as under 'none', with the same gradients.
* Eval forwards and torch.export (the shrink capture) run the blocks
  directly; an unknown mode raises ValueError; the nets without remat in
  the JAX package (Faster R-CNN's small trunk) stay unwrapped.
* Two gloo ranks with exact sync-BN: ResNet-20 full-prec under 'full'
  bit-identical to 'none' on both ranks; the collectives of a step: one
  gradient all-reduce and two a BN (forward, backward) under 'none', and
  one more for each of the 20 BNs inside the blocks under 'full' (the
  recompute's forward).
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.nn import layers as tl

torch.set_num_threads(2)
TESTS = os.path.dirname(os.path.abspath(__file__))
MODES = ('save_convs', 'full')


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _nets():
    from pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc import build_backbone
    from pocketflow_tpu_torch.nets.mobilenet import MobileNetV1, MobileNetV2
    from pocketflow_tpu_torch.nets.resnet import ResNetCifar, ResNetImageNet
    f32 = torch.float32
    # name -> (constructor, input shape, blocks)
    return {
        'resnet20': (lambda: ResNetCifar(3, 10, f32), (4, 32, 32, 3), 9),
        'resnet18-s2d': (lambda: ResNetImageNet(18, 10, f32, stem_space_to_depth=True),
                         (4, 32, 32, 3), 8),
        'mobilenet-v1': (lambda: MobileNetV1(10, 0.25, f32), (4, 32, 32, 3), 13),
        'mobilenet-v2': (lambda: MobileNetV2(10, 0.25, f32), (4, 32, 32, 3), 17),
        'frcnn-resnet18': (lambda: build_backbone('resnet18', f32), (2, 64, 64, 3), 6),
    }


NET_NAMES = ('resnet20', 'resnet18-s2d', 'mobilenet-v1', 'mobilenet-v2', 'frcnn-resnet18')


def _recompute_spy(monkeypatch):
    """The labels of the block recomputes that ran, in order."""
    ran = []
    real = tl._recompute

    @contextlib.contextmanager
    def counted(inner, policy, entry, label):
        with real(inner, policy, entry, label):
            ran.append(label)
            yield

    monkeypatch.setattr(tl, '_recompute', counted)
    return ran


def _model(name, mode):
    build, shape, nb_blocks = _nets()[name]
    with TFLAGS.scope(remat_blocks=mode):
        model = build()
    tl.reset_parameters(model, torch.Generator().manual_seed(0))
    blocks = [m for m in model.modules() if isinstance(m, tl.RematBlock)]
    assert len(blocks) == nb_blocks and all(b.remat == mode for b in blocks)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32))
    return model.train(), x


def _square_loss(out):
    return sum((o ** 2).sum() for o in (out if isinstance(out, tuple) else (out,)))


_BASELINES = {}


def _baseline(name):
    """'none': the gradients and BN statistics after one forward and
    backward, the statistics at the start and after one no-grad forward."""
    if name not in _BASELINES:
        model, x = _model(name, 'none')
        start = {k: b.clone() for k, b in model.named_buffers()}
        with torch.no_grad():
            model(x)
        once = {k: b.clone() for k, b in model.named_buffers()}
        model, x = _model(name, 'none')
        _square_loss(model(x)).backward()
        _BASELINES[name] = (start, once, {k: p.grad for k, p in model.named_parameters()},
                            dict(model.named_buffers()))
    return _BASELINES[name]


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('name', NET_NAMES)
def test_gradients_and_bn_statistics_equal_none(name, mode, monkeypatch):
    start, once, grads, stats = _baseline(name)
    ran = _recompute_spy(monkeypatch)
    model, x = _model(name, mode)
    _square_loss(model(x)).backward()
    assert len(ran) == _nets()[name][2]  # each block recomputed once in the backward
    for key, param in model.named_parameters():
        assert torch.equal(param.grad, grads[key]), key
    for key, buf in model.named_buffers():
        assert torch.equal(buf, stats[key]) and torch.equal(buf, once[key]), key
        assert not torch.equal(buf, start[key]), key  # moved, by one momentum step


@pytest.fixture(scope='module')
def jax_resnet18():
    """The JAX package's ResNet-18 gradients of sum(logits^2) under 'none',
    train-mode BN, batch 4 at 64x64, and its three reruns."""
    import jax
    import jax.numpy as jnp
    from pocketflow_tpu.nets.resnet import ResNetImageNet
    from torch_slice_parity import PERTURBATION
    x = np.random.default_rng(0).random((4, 64, 64, 3)).astype(np.float32)
    model = ResNetImageNet(resnet_size=18, nb_classes=10, dtype=jnp.float32)
    variables = jax.device_get(jax.jit(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))())

    @jax.jit
    def grads(params, images):
        def loss(p):
            out, _ = model.apply({'params': p, 'batch_stats': variables['batch_stats']},
                                 images, train=True, mutable=['batch_stats'])
            return jnp.sum(out ** 2)
        return jax.grad(loss)(params)

    def flat(tree):
        return {'.'.join(p.key for p in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}

    rng = np.random.default_rng(1)
    perturbed = jax.tree_util.tree_map(
        lambda a: (a * (1 + PERTURBATION * rng.standard_normal(a.shape))).astype(np.float32),
        variables['params'])
    reruns = [flat(grads(variables['params'],
                         (x * (1 + PERTURBATION * rng.standard_normal(x.shape))).astype(
                             np.float32))),
              flat(grads(perturbed, x)),
              flat(grads(variables['params'], x[::-1].copy()))]
    return x, variables, flat(grads(variables['params'], x)), reruns


@pytest.mark.parametrize('mode', MODES)
def test_port_resnet18_under_remat_matches_jax(jax_resnet18, mode):
    from pocketflow_tpu_torch.core.bridge import load_jax_numpy
    from pocketflow_tpu_torch.nets.resnet import ResNetImageNet
    from torch_slice_parity import _tolerance
    x, variables, want, reruns = jax_resnet18
    with TFLAGS.scope(remat_blocks=mode):
        model = ResNetImageNet(18, 10, torch.float32)
    load_jax_numpy(model, variables['params'], variables['batch_stats'])
    model.train()
    _square_loss(model(torch.from_numpy(x))).backward()
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    bad = []
    for key, value in want.items():
        floor = max(float(np.linalg.norm(r[key] - value)) for r in reruns)
        err = float(np.linalg.norm(got[key] - value))
        if not err <= _tolerance(value, floor):
            bad.append((key, err, _tolerance(value, floor)))
    assert bad == []


def _snapshot(state):
    """Parameters, buffers, SGD momentum and every `extra` tensor, cloned."""
    out = {'model/' + k: v.detach().clone() for k, v in state.model.state_dict().items()}
    for i, group in enumerate(state.optimizer.state.values()):
        out.update({'opt/%d/%s' % (i, k): v.clone() for k, v in group.items()
                    if torch.is_tensor(v)})
    stack = [('extra', state.extra or {})]
    while stack:
        prefix, node = stack.pop()
        if isinstance(node, dict):
            stack.extend((prefix + '/' + k, v) for k, v in node.items())
        elif torch.is_tensor(node):
            out[prefix] = node.detach().clone()
    return out


LEARNER_FLAGS = dict(synthetic_data=True, batch_size=4, batch_size_eval=4, nb_smpls_train=16,
                     nb_smpls_eval=8, compute_dtype='float32', resnet_size=20, rand_seed=0,
                     bn_stats_subsample=1)
# kind -> (extra flags, plain calls of one step under 'none', and under remat)
LEARNER_STEPS = {
    'qat-act8': (dict(uql_weight_bits=4, uql_activation_bits=8), 1 + 19, 1 + 19 + 18),
    'uniform-tf': (dict(uqtf_quant_delay=0), 1, 1),
    'non-uniform': (dict(), 19, 19 + 18),
    'pruned-qat': (dict(uql_weight_bits=4, uql_activation_bits=32), 1, 1),
}
_STEPS = {}


def _mixed_bits(learner):
    """Activation bits that differ from site to site (32: passed through),
    so that a recompute reading a site at another's index shows."""
    return [(4, 6, 8, 32)[i % 4] for i in range(learner.statistics['nb_activations'])]


def _learner_step(kind, mode):
    """One train step of `kind` on ResNet-20 under `mode`: (the state after
    it, the fake-quant counters of the step), run once."""
    if (kind, mode) not in _STEPS:
        _STEPS[kind, mode] = _run_learner_step(kind, mode)
    return _STEPS[kind, mode]


def _run_learner_step(kind, mode):
    from pocketflow_tpu_torch.learners.nonuniform_quantization.learner import (
        NonUniformQuantLearner)
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.learners.uniform_quantization_tf.learner import (
        UniformQuantTFLearner)
    from pocketflow_tpu_torch.learners.weight_sparsification import pruned_qat
    from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper
    from pocketflow_tpu_torch.ops import fake_quant as fq
    with TFLAGS.scope(**LEARNER_FLAGS, **LEARNER_STEPS[kind][0], remat_blocks=mode):
        if kind == 'uniform-tf':
            learner = UniformQuantTFLearner(None, ModelHelper(), device='cpu')
            state, tx, _ = learner.init_state_quant()
            nb_acts = len(state.extra['act_min'])  # a range of its own at each site
            state.extra['act_min'].copy_(torch.linspace(-0.5, 0.0, nb_acts))
            state.extra['act_max'].copy_(torch.linspace(1.0, 6.0, nb_acts))
            step = learner.build_qat_train_step(tx, freeze_bn=False)
        elif kind == 'non-uniform':
            learner = NonUniformQuantLearner(None, ModelHelper(), device='cpu')
            state, tx, _ = learner.init_state_quant(a_bit_list=_mixed_bits(learner))
            step = learner.build_quant_train_step(tx)
        else:
            learner = UniformQuantLearner(None, ModelHelper(), device='cpu')
            state, tx, _ = learner.init_state_quant(
                a_bit_list=_mixed_bits(learner) if kind == 'qat-act8' else None)
            if kind == 'pruned-qat':
                state, step = pruned_qat.build_pruned_qat_step(
                    learner, tx, state, pruned_qat.channel_masks(state.model))
            else:
                step = learner.build_quant_train_step(tx)
        batch = learner.put_batch(next(learner.dataset_train.build()))
        fq.reset_counters()
        state, _ = step(state, batch, learner.generator(0))
        return _snapshot(state), fq.counters()


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('kind', list(LEARNER_STEPS))
def test_learner_step_equals_none(kind, mode):
    want, want_counts = _learner_step(kind, 'none')
    got, counts = _learner_step(kind, mode)
    assert set(got) == set(want)
    assert [k for k in want if not torch.equal(got[k], want[k])] == []
    _, plain_none, plain_remat = LEARNER_STEPS[kind]
    zero = {k: 0 for k in counts}
    assert want_counts == {**zero, 'plain': plain_none}
    assert counts == {**zero, 'plain': plain_remat}


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('kind,grouped', [('qat-act8', 'fake_quant_group'),
                                          ('uniform-tf', 'fake_quant_bucket_group')])
def test_grouped_weight_call_runs_outside_the_checkpointed_regions(kind, grouped, mode,
                                                                    monkeypatch):
    """The policy's grouped weight fake-quant runs once a forward, before the
    first block's region (QuantPolicy.prepare / RangeQuantPolicy.prepare),
    never inside a checkpoint's forward or recompute."""
    from torch.utils import checkpoint
    from pocketflow_tpu_torch.ops import fake_quant as fq
    inside, calls = [0], []
    real_checkpoint, real_grouped = checkpoint.checkpoint, getattr(fq, grouped)

    def counted_checkpoint(*args, **kwargs):
        inside[0] += 1
        try:
            return real_checkpoint(*args, **kwargs)
        finally:
            inside[0] -= 1

    def counted_grouped(*args, **kwargs):
        calls.append((inside[0], tl.recomputing()))
        return real_grouped(*args, **kwargs)

    monkeypatch.setattr(checkpoint, 'checkpoint', counted_checkpoint)
    monkeypatch.setattr(fq, grouped, counted_grouped)
    _run_learner_step(kind, mode)
    assert calls == [(0, False)]


def test_capture_under_remat_records_each_layer_once():
    """A layerwise regression's forward with gradients (CapturePolicy with
    stop_input_grads, BN training) under 'full': the same captures as
    under 'none', kept after the backward, and the same gradients."""
    from pocketflow_tpu_torch.learners.capture import capture_forward
    out = {}
    for mode in ('none', 'full'):
        model, x = _model('resnet20', mode)
        captured = capture_forward(model, x, stop_input_grads=True, train=True)
        sum((y ** 2).sum() for _, y in captured).backward()
        out[mode] = ([path for path, _ in captured],
                     {k: p.grad for k, p in model.named_parameters()})
    assert out['full'][0] == out['none'][0] and len(out['none'][0]) == 22
    grads = out['none'][1]
    assert sum(g is not None for g in grads.values()) >= 22  # each conv/dense kernel
    assert all((v is None and out['full'][1][k] is None) or torch.equal(out['full'][1][k], v)
               for k, v in grads.items())


def test_eval_and_export_run_the_blocks_directly(monkeypatch):
    """Under 'full': eval-mode and no-grad train-mode forwards equal
    'none''s with no checkpoint, and the shrink's torch.export capture gives
    the same conv graph."""
    from pocketflow_tpu_torch.tools.shrink_graph import capture_conv_graph
    calls = []
    real = tl._checkpointed
    monkeypatch.setattr(tl, '_checkpointed', lambda *a: calls.append(a) or real(*a))
    (none, x), (full, _) = _model('resnet20', 'none'), _model('resnet20', 'full')
    with torch.no_grad():
        for train in (False, True):
            assert torch.equal(none.train(train)(x), full.train(train)(x))
    graphs = [capture_conv_graph(m, (1, 32, 32, 3)) for m in (none, full)]
    assert graphs[0] == graphs[1] and len(graphs[0].sites) > 0
    assert calls == []


def test_unknown_mode_raises_and_unported_nets_stay_unwrapped():
    from pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc import FasterRCNN, build_backbone
    from pocketflow_tpu_torch.nets.resnet import ResNetCifar
    with TFLAGS.scope(remat_blocks='every_other'):
        with pytest.raises(ValueError, match='every_other'):
            ResNetCifar(3, 10, torch.float32)
    with TFLAGS.scope(remat_blocks='full'):
        small = build_backbone('small', torch.float32)
        detector = FasterRCNN(backbone_name='resnet18', dtype=torch.float32)
    assert [m.remat for m in small.modules() if isinstance(m, tl.RematBlock)] == ['none'] * 4
    assert [m.remat for m in detector.modules() if isinstance(m, tl.RematBlock)] == ['full'] * 6


def test_two_ranks_sync_bn_full_equals_none(tmp_path):
    from pocketflow_tpu_torch.tools import launch
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(8, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, size=8).astype(np.int32)
    flags = {**LEARNER_FLAGS, 'nb_smpls_train': 64}
    ranks = launch.spawn('torch_dist_ranks:remat_step', 2,
                         dict(flags=flags, images=images, labels=labels,
                              modes=('none', 'full')),
                         work_dir=str(tmp_path), paths=[TESTS])
    nb_bn, nb_bn_in_blocks = 21, 20
    for out in ranks:
        assert out['full']['checksum'] == out['none']['checksum'] == ranks[0]['none']['checksum']
        assert out['none']['counts'] == {'all_reduce': 1 + 2 * nb_bn, 'broadcast': 0,
                                         'barrier': 0}
        assert out['full']['counts'] == {'all_reduce': 1 + 2 * nb_bn + nb_bn_in_blocks,
                                         'broadcast': 0, 'barrier': 0}
