"""The port's uniform-tf learner (pocketflow_tpu_torch/learners/
uniform_quantization_tf) and fake_quant_with_range against the JAX package
on the CPU:

* fake_quant_with_range at 8 bits, bf16 and fp32 inputs, ranges [0, 6],
  [0.02, 6.1], [-1.3, 2.2] and [0.5, 4]: values bit-equal to the JAX op's
  and the gradient's mask (nudged_min <= x <= nudged_max) equal; a gradient
  passed everywhere must fail;
* one train step of MobileNet-v1 @ 64, depth 0.5, batch 8, fp32, 8-bit
  weights and 16-bit activations, from the bridged JAX state, activation
  ranges and BN statistics of another batch, against JAX's
  build_qat_train_step in each regime: before the quant delay (the port
  makes no fake-quant call), quantized with BN training, quantized with BN
  frozen (the statistics bit-unchanged); parameters, BN statistics, act_min
  and act_max held to the slice bound (tests/torch_step_parity.py; EMA decay
  0.9 so that a range update shows).  Two planted faults must fail the
  quantized step: the EMA taken before the forward, and the gradient passed
  outside the nudged range;
* the resume contract: a second train() resumes from uqtf_save_path and
  runs 0 steps;
* main.main --model=mobilenet_at_ilsvrc12 --learner=uniform-tf on the CPU;
  the same run under --remat_blocks=full writes the same checkpoint, and an
  unknown --remat_blocks mode raises ValueError.
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
from pocketflow_tpu_torch.core.bridge import extra_from_jax, load_jax_numpy
from test_torch_mobilenet import MOBILENET_SMALL
from torch_slice_parity import _deterministic_augment
from torch_step_parity import flat_state, jax_runs, moved_past_bound, out_of_bound

torch.set_num_threads(2)
RANGES = [(0.0, 6.0), (0.02, 6.1), (-1.3, 2.2), (0.5, 4.0)]
# the QAT rate is 1e-4 * lrn_rate_init * batch / 128 (MobileNet's quant
# finetune): 16000 gives 0.1.  The step's activations take 16 bits: at 8, a
# level a rounding away from its edge flips between sum orders and the flips
# cascade through the 27 sites, so that JAX reruns perturbed by 1e-7 move the
# parameters as far as the step does and no bound tells a fault; at 16 the
# reruns' spread is ~10x below the step's movement
UQTF_SMALL = dict(MOBILENET_SMALL, lrn_rate_init=16000.0, uqtf_ema_decay=0.9,
                  uqtf_activation_bits=16, uqtf_quant_delay=1)
# each regime's starting step under --uqtf_quant_delay=1 (one compiled JAX
# step serves the first two), and whether BN is frozen
REGIMES = {'delay': dict(step=0, freeze_bn=False),
           'quantized': dict(step=1, freeze_bn=False),
           'frozen': dict(step=1, freeze_bn=True)}


@pytest.fixture(autouse=True)
def _port_flags():
    import pocketflow_tpu_torch.learners.uniform_quantization_tf.learner  # noqa: F401
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _fqwr_case(lo, hi, dtype):
    """(x fp32 values, the JAX output, the JAX gradient's mask) at 8 bits."""
    from pocketflow_tpu.ops import fake_quant as jfq
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(4000) * 2.5 + 1.0).astype(np.float32)
    x[:6] = [lo, hi, 0.0, 6.0, -0.01, 6.01]  # the range's ends and both sides of [0, 6]
    jdtype = {'bfloat16': jnp.bfloat16, 'float32': jnp.float32}[dtype]
    jx = jnp.asarray(x).astype(jdtype)
    args = (jnp.float32(lo), jnp.float32(hi), jnp.float32(8.0))
    out, vjp = jax.vjp(lambda v: jfq.fake_quant_with_range(v, *args), jx)
    (grad,) = vjp(jnp.ones_like(out))
    return (np.asarray(jx.astype(jnp.float32)), np.asarray(out.astype(jnp.float32)),
            np.asarray(grad.astype(jnp.float32)) != 0)


def _port_fqwr(x, lo, hi, dtype):
    from pocketflow_tpu_torch.ops import fake_quant as fq
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    out = fq.fake_quant_with_range(tx, torch.tensor(lo), torch.tensor(hi), torch.tensor(8.0))
    out.backward(torch.ones_like(out))
    return out.detach().float().numpy(), tx.grad.float().numpy() != 0


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('lo,hi', RANGES)
def test_fake_quant_with_range_matches_jax(lo, hi, dtype):
    x, want, want_mask = _fqwr_case(lo, hi, dtype)
    got, got_mask = _port_fqwr(x, lo, hi, dtype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_mask, want_mask)
    # the nudge puts 0 on the grid: a zero activation stays exactly 0
    assert lo > 0 or got[2] == 0.0


def test_gradient_outside_the_nudged_range_fails(monkeypatch):
    """Planted fault: the STE passes the gradient everywhere."""
    from pocketflow_tpu_torch.ops import fake_quant as fq
    monkeypatch.setattr(fq._FakeQuantWithRange, 'backward',
                        staticmethod(lambda ctx, g: (g, None, None, None)))
    x, _, want_mask = _fqwr_case(0.5, 4.0, 'bfloat16')
    _, got_mask = _port_fqwr(x, 0.5, 4.0, 'bfloat16')
    assert not np.array_equal(got_mask, want_mask)


@pytest.fixture(scope='module')
def learners():
    """The JAX and port learners on MobileNet-v1 @ 64 (depth 0.5, fp32), the
    bridged initial state with activation ranges off their init (act_min 0,
    act_max in [1.5, 4]: many activations clip), and one batch."""
    from pocketflow_tpu.learners.uniform_quantization_tf.learner import (
        UniformQuantTFLearner as JLearner)
    from pocketflow_tpu.nets.mobilenet_at_ilsvrc12 import ModelHelper as JHelper
    from pocketflow_tpu_torch.learners.uniform_quantization_tf.learner import (
        UniformQuantTFLearner as TLearner)
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper as THelper
    mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:1], ('data',), (1,)))
    with JFLAGS.scope(**UQTF_SMALL), TFLAGS.scope(**UQTF_SMALL):
        jlearner = JLearner(None, JHelper())
        tlearner = TLearner(None, THelper(), device='cpu')
        jstate, jtx, _ = jlearner.init_state_quant()
    for lrn in (jlearner, tlearner):
        _deterministic_augment(lrn.dataset_train)
    nb_acts = tlearner.statistics['nb_activations']
    rng = np.random.default_rng(3)
    snapshot = jax.tree_util.tree_map(np.array, jax.device_get(
        {'params': jstate.params, 'batch_stats': jstate.batch_stats,
         'opt_state': jstate.opt_state}))
    snapshot['extra'] = {'act_min': np.zeros(nb_acts, np.float32),
                         'act_max': rng.uniform(1.5, 4.0, nb_acts).astype(np.float32)}
    images, labels = jlearner.dataset_train.synthesize_arrays(64)
    # running statistics of a trained net, so that the frozen-BN forward
    # does not fade a random net's activations: each BN's statistics of a
    # train-mode forward of another batch (the port's BN at momentum 0)
    with TFLAGS.scope(**UQTF_SMALL):
        model = tlearner.create_model()
    load_jax_numpy(model, snapshot['params'], snapshot['batch_stats'])
    for module in model.modules():
        if hasattr(module, 'momentum'):
            module.momentum = 0.0
    with torch.no_grad():
        model(tlearner.dataset_train.augment(torch.from_numpy(images[8:16]), None, False))
    for name, value in model.named_buffers():
        *path, leaf = name.split('.')
        node = snapshot['batch_stats']
        for key in path:
            node = node[key]
        node[leaf] = value.numpy().copy()
    yield dict(jlearner=jlearner, tlearner=tlearner, jstate=jstate, jtx=jtx,
               snapshot=snapshot, images=images[:8], labels=labels[:8])
    mesh_lib.reset_global_mesh()


def _jax_step(env, freeze_bn, step_index):
    jlearner, template = env['jlearner'], env['jstate']
    with JFLAGS.scope(**UQTF_SMALL):
        step = jlearner.build_qat_train_step(env['jtx'], freeze_bn)

    def run(snapshot, images, labels):
        state = template.replace(
            step=jnp.asarray(step_index, jnp.int32),
            params=jax.tree_util.tree_map(jnp.asarray, snapshot['params']),
            batch_stats=jax.tree_util.tree_map(jnp.asarray, snapshot['batch_stats']),
            opt_state=jax.tree_util.tree_map(jnp.asarray, snapshot['opt_state']),
            extra=jax.tree_util.tree_map(jnp.asarray, snapshot['extra']))
        with JFLAGS.scope(**UQTF_SMALL):  # the policy reads its bits when the step traces
            state, _ = step(state, {'image': jnp.asarray(images),
                                    'label': jnp.asarray(labels)}, jax.random.PRNGKey(0))
        after = jax.tree_util.tree_map(np.array, jax.device_get(
            (state.params, state.batch_stats, state.extra)))
        return flat_state(*after)
    return run


def _port_step(env, regime, snapshot):
    """The port's step from `snapshot`: (flat state after it, plain
    fake-quant calls it made)."""
    from pocketflow_tpu_torch.ops import fake_quant as fq
    cfg = REGIMES[regime]
    tlearner = env['tlearner']
    with TFLAGS.scope(**UQTF_SMALL):
        state, tx, _ = tlearner.init_state_quant()
        load_jax_numpy(state.model, snapshot['params'], snapshot['batch_stats'])
        state.extra = extra_from_jax(snapshot['extra'])
        state.step = cfg['step']
        step = tlearner.build_qat_train_step(tx, cfg['freeze_bn'])
    fq.reset_counters()
    state, _ = step(state, tlearner.put_batch({'image': env['images'], 'label': env['labels']}),
                    None)
    plain = fq.counters()['plain']
    after = flat_state({k: v.detach().numpy() for k, v in state.params.items()},
                       {k: v.numpy() for k, v in state.batch_stats.items()},
                       {k: v.numpy() for k, v in state.extra.items()})
    return after, plain


@pytest.fixture(scope='module')
def jax_steps(learners):
    """Each regime's JAX step from the snapshot and its three reruns."""
    steps = {freeze_bn: {} for freeze_bn in (False, True)}
    out = {}
    for regime, cfg in REGIMES.items():
        if cfg['step'] not in steps[cfg['freeze_bn']]:
            steps[cfg['freeze_bn']][cfg['step']] = _jax_step(learners, cfg['freeze_bn'],
                                                              cfg['step'])
        out[regime] = jax_runs(steps[cfg['freeze_bn']][cfg['step']], learners['snapshot'],
                               learners['images'], learners['labels'])
    return out


@pytest.mark.parametrize('regime', list(REGIMES))
def test_step_matches_jax(learners, jax_steps, regime):
    want, reruns = jax_steps[regime]
    got, plain = _port_step(learners, regime, learners['snapshot'])
    assert out_of_bound(want, reruns, got) == []
    # one grouped call for the 28 weights and 27 plain fake_quant_with_range
    # passes (which count no call) a quantized forward; none before the delay
    assert plain == (0 if regime == 'delay' else 1)
    start = flat_state(learners['snapshot']['params'], learners['snapshot']['batch_stats'],
                       learners['snapshot']['extra'])
    stats = [k for k in want if k.endswith('/mean') or k.endswith('/var')]
    moved = [k for k in stats if not np.array_equal(want[k], start[k])]
    assert (moved == []) == (regime == 'frozen') and len(stats) == 2 * 27
    if regime == 'frozen':
        assert all(np.array_equal(got[k], start[k]) for k in stats)
    # a wrong update would show: most parameters move past their bound
    # (measured: 86% before the delay, 99% quantized, 100% frozen)
    params = {k: v for k, v in want.items() if k not in stats and not k.startswith('extra/')}
    assert moved_past_bound(start, params, reruns) >= (0.8 if regime == 'delay' else 0.95)
    # the ranges moved by the EMA of this batch's (min, max) in every regime
    assert not np.array_equal(want['extra/act_max'], start['extra/act_max'])


def test_ema_before_the_forward_fails(learners, jax_steps, monkeypatch):
    """Planted fault: each site's range moves by the EMA of its batch before
    the forward quantizes against it (and again after the step)."""
    from pocketflow_tpu_torch.learners.uniform_quantization_tf import learner as uqtf
    process_act = uqtf.RangeQuantPolicy.process_act

    def early(policy, path, act):
        if path.startswith('act/'):
            idx = int(path.split('/')[1])
            lo, hi = torch.aminmax(act.detach())
            with torch.no_grad():
                policy.act_min[idx] = 0.9 * policy.act_min[idx] + 0.1 * lo
                policy.act_max[idx] = 0.9 * policy.act_max[idx] + 0.1 * hi
        return process_act(policy, path, act)

    monkeypatch.setattr(uqtf.RangeQuantPolicy, 'process_act', early)
    want, reruns = jax_steps['quantized']
    got, _ = _port_step(learners, 'quantized', learners['snapshot'])
    bad = {key for key, _, _ in out_of_bound(want, reruns, got)}
    assert {'extra/act_min', 'extra/act_max'} & bad and len(bad) > 10


def test_gradient_everywhere_fails_the_step(learners, jax_steps, monkeypatch):
    """Planted fault: fake_quant_with_range passes the gradient outside its
    nudged range (many activations clip at act_max in [1.5, 4])."""
    from pocketflow_tpu_torch.ops import fake_quant as fq
    monkeypatch.setattr(fq._FakeQuantWithRange, 'backward',
                        staticmethod(lambda ctx, g: (g, None, None, None)))
    want, reruns = jax_steps['quantized']
    got, _ = _port_step(learners, 'quantized', learners['snapshot'])
    assert len(out_of_bound(want, reruns, got)) > 10


def _mobilenet_argv(tmp_path):
    return ['--model=mobilenet_at_ilsvrc12', '--mobilenet_depth_mult=0.25', '--synthetic_data',
            '--ilsvrc_image_size=32', '--batch_size=8', '--batch_size_eval=8',
            '--nb_smpls_train=16', '--nb_smpls_eval=8', '--compute_dtype=float32',
            '--summ_step=1', '--log_dir=%s' % (tmp_path / 'logs'),
            '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt'),
            '--uqtf_save_path=%s' % (tmp_path / 'uqtf' / 'model.ckpt')]


@pytest.fixture
def small_eval(monkeypatch):
    """64 synthetic samples instead of 2048 keep the eval loops short, and
    the JSONL summaries spare the tests TensorBoard's imports."""
    from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset
    monkeypatch.setattr(Ilsvrc12Dataset, '_load_arrays', lambda self: self.synthesize_arrays(64))
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)


def test_second_train_resumes_and_runs_no_step(tmp_path, small_eval):
    from pocketflow_tpu_torch.core import checkpoint as ckpt
    from pocketflow_tpu_torch.learners.uniform_quantization_tf.learner import (
        UniformQuantTFLearner)
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper
    TFLAGS.parse_args(_mobilenet_argv(tmp_path) + ['--uql_quant_epochs=1', '--nb_epochs_rat=1'])
    steps = []
    for run in range(2):
        learner = UniformQuantTFLearner(None, ModelHelper(), device='cpu')
        build = learner.build_qat_train_step

        def counting(tx, freeze_bn, build=build):
            step = build(tx, freeze_bn)

            def counted(state, batch, generator):
                steps.append(run)
                return step(state, batch, generator)
            return counted

        learner.build_qat_train_step = counting
        state = learner.train()
        assert state.step == 2
    assert steps == [0, 0]
    payload = ckpt.restore_latest(str(tmp_path / 'uqtf' / 'model.ckpt'))
    assert payload['step'] == 2 and payload['extra']['act_max'].shape == (27,)
    spec = learner.export_quant_spec(state)
    assert len(spec['weight_paths']) == 28 and spec['weight_bits'] == spec['act_bits'] == 8


def test_main_runs_uniform_tf_on_cpu(tmp_path, small_eval):
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.core import checkpoint as ckpt
    from pocketflow_tpu_torch.ops import fake_quant as fq
    argv = _mobilenet_argv(tmp_path)
    port_main.main(argv + ['--nb_epochs_rat=0.01'], device='cpu')  # the baseline: 2 steps
    fq.reset_counters()
    learner = port_main.main(argv + ['--learner=uniform-tf', '--uqtf_quant_delay=1',
                                     '--uqtf_freeze_bn_delay=2', '--uql_quant_epochs=3',
                                     '--nb_epochs_rat=0.5'], device='cpu')
    assert learner.statistics['nb_matmuls'] == 28
    payload = ckpt.restore_latest(str(tmp_path / 'uqtf' / 'model.ckpt'))
    assert payload['step'] == 3
    assert not torch.equal(payload['extra']['act_max'], torch.full((27,), 6.0))
    # steps 2 and 3 quantize (one grouped call each), step 1 does not; then
    # one a forward of the eval over 64 samples at batch 8
    assert fq.counters()['plain'] == 2 + 8
    # the same run under --remat_blocks=full (its step 3 the frozen-BN step
    # with gradients, rematerialized too) writes the same checkpoint
    full = port_main.main(argv + ['--learner=uniform-tf', '--uqtf_quant_delay=1',
                                  '--uqtf_freeze_bn_delay=2', '--uql_quant_epochs=3',
                                  '--nb_epochs_rat=0.5', '--remat_blocks=full',
                                  '--uqtf_save_path=%s' % (tmp_path / 'full' / 'model.ckpt')],
                          device='cpu')
    assert full.statistics == learner.statistics
    got = ckpt.restore_latest(str(tmp_path / 'full' / 'model.ckpt'))
    assert got['step'] == 3
    for key in ('model', 'extra'):
        assert got[key].keys() == payload[key].keys()
        assert all(torch.equal(got[key][k], payload[key][k]) for k in payload[key]), key
    with pytest.raises(ValueError, match='unknown remat_blocks mode'):
        port_main.main(argv + ['--learner=uniform-tf', '--remat_blocks=every_other'],
                       device='cpu')
