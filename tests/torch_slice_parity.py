"""The whole slice: the port's UniformQuantLearner on ResNet-50 against the
JAX package's, from one set of parameters carried across by the bridge.
Shared by tests/test_torch_qat_slice.py (per-tensor weight quantization),
tests/test_torch_qat_slice_buckets.py (--uql_use_buckets, channel buckets),
tests/test_torch_qat_slice_act8.py (--uql_activation_bits=8: the 49
activations through fake_quant_select) and tests/test_torch_masking.py (bench.py's composed pruned+QAT step: channel
masks made with numpy and handed to both packages, masked gradients, the
masks re-applied after each update), which run on separate test workers.
`_run_small` takes the same steps for the small nets of the model zoo
(tests/test_torch_cifar_step_*.py, tests/test_torch_qat_act8_exact.py), with
a third JAX rerun in the spread: the same batch in reverse order, the same
function with the sums in another order.  On ResNet-20 @ CIFAR-10 at batch 8
the first layers' gradients cancel structurally (BN's backward), so that the
rounding of the sums moves them by up to 1e-3 relative: against a float64
evaluation of the port's step, the JAX fp32 step's conv_init gradient sits
1.1e-3 away and the port's 1.3e-6, and the same JAX step with its batch
reversed lands as far; inputs and parameters perturbed by 1e-7 do not
excite it (2e-6).

Size: --ilsvrc_image_size=64, batch 8, fp32, synthetic ILSVRC-12.  The
augmentation is switched to its deterministic path on both learners'
instances (the two frameworks' random streams differ), and both take the
same two host batches.

Why 64 and 8, and why each step starts from the JAX state: a QAT step of a
randomly initialised ResNet-50 is chaotic at small sizes.  At image size 32
the last stage is 1x1 and train-mode BN normalizes over 4 values: JAX reruns
whose starting parameters or images are perturbed by 1e-7 relative (the size
of the rounding differences between the two frameworks) move the parameters
after two chained steps about as far from the reference run as the two steps
move them (median ratio 0.87), so no tolerance tells a right update from a
wrong one.  At 64 (last stage 2x2, BN over 32 values) one step from a given
state moves most tensors far past that spread, but a second chained step
again amplifies the first step's rounding differences.  So each of the two
steps is held against the JAX step from the same state: the port takes
step 1 from the bridged initial state and step 2 from the bridged JAX state
after step 1 (parameters, BN statistics and SGD momentum buffers).

Tolerances, per tensor, on the L2 norm of the difference from the JAX step:
* quant sites: equal (52 weights, 49 activations); at --uql_activation_bits
  below 32, each activation site of the port's eval forward returns what the
  JAX QuantPolicy.process_act returns on the same input, bit for bit;
* eval logits: rtol=atol=1e-3, per element; and, as the steps below, within
  the slice's bound of the JAX package's own spread (two JAX evals with the
  images or the parameters perturbed by 1e-7 relative);
* each step's loss and metrics, and the parameters and BN statistics after
  it: ||port - jax|| <= ||ATOL + RTOL*|jax||| + NOISE_FACTOR * floor, with
  rtol=1e-4, atol=1e-5, where `floor` is the JAX package's own spread: the
  larger ||rerun - jax|| of two JAX reruns of the same step, one with the
  input images and one with the starting parameters perturbed by 1e-7
  relative.  A per-element bound does not hold for either framework
  against itself: the spread gathers in a few elements of a tensor (a
  quantization level that flips), which a norm spreads over the tensor.
  test_two_steps_move_parameters_past_the_tolerance shows that most tensors
  move by more than the bound applied to them, so a wrong update fails;
* the size of each step's whole update: test_update_has_the_reference_size
  (a learning rate off by a few percent).
Checked against broken copies of the port: a Nesterov update fails the
parameters, a running variance 1% off fails the BN statistics, and a
learning rate 5% off fails the update's size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.core import mesh as mesh_lib
from pocketflow_tpu.learners.uniform_quantization import utils as juq
from pocketflow_tpu.learners.uniform_quantization.learner import UniformQuantLearner as JLearner
from pocketflow_tpu.learners.weight_sparsification import masking as jmasking
from pocketflow_tpu.nets.resnet_at_ilsvrc12 import ModelHelper as JHelper
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core.bridge import from_jax_numpy, load_jax_numpy
from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner as TLearner
from pocketflow_tpu_torch.learners.weight_sparsification.pruned_qat import (
    build_pruned_qat_step, channel_masks)
from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper as THelper

torch.set_num_threads(2)

BATCH = 8
SMALL = dict(ilsvrc_image_size=64, batch_size=BATCH, batch_size_eval=BATCH, nb_smpls_train=64,
             nb_smpls_eval=16, compute_dtype='float32', synthetic_data=True,
             resnet_stem_s2d=True, rand_seed=0,
             # the QAT schedule's rate is 1e-4 * lrn_rate_init * batch / 256:
             # 1000 gives 0.1 * 8 / 256, the full-precision ResNet rate, so
             # that a step moves most tensors well past the tolerance
             lrn_rate_init=1000.0)
# ResNet-20 @ CIFAR-10 for `_run_small`: the full-precision rate is
# lrn_rate_init * batch / 128, the QAT finetune's 1e-3 of it; each is 0.1
CIFAR_SMALL = dict(batch_size=BATCH, batch_size_eval=BATCH, nb_smpls_train=64,
                   nb_smpls_eval=16, compute_dtype='float32', synthetic_data=True,
                   rand_seed=0, resnet_size=20)
CIFAR_RATE = {'full-prec': 1.6, 'uniform': 1600.0}
RTOL, ATOL = 1e-4, 1e-5
NOISE_FACTOR = 2.0
PERTURBATION = 1e-7
NB_STEPS = 2


def _flat(tree, prefix=''):
    out = {}
    for key, value in tree.items():
        path = '%s/%s' % (prefix, key) if prefix else key
        if isinstance(value, dict):
            out.update(_flat(value, path))
        else:
            out[path] = np.array(value)
    return out


def _deterministic_augment(dataset):
    """The is_train=False path on this instance (no random flip)."""
    cls = type(dataset)
    dataset.augment_xy = lambda batch, rng, is_train: cls.augment_xy(dataset, batch, rng, False)


def _momentum_trace(opt_state):
    """The SGD momentum tree of optax.sgd's state."""
    traces = [s.trace for s in opt_state if hasattr(s, 'trace')]
    assert len(traces) == 1, opt_state
    return traces[0]


def _load_port_state(tstate, snapshot):
    """Put a JAX state snapshot (step, params, batch_stats, opt_state) into
    the port's TrainState: parameters and statistics through the bridge,
    momentum buffers through the same mapping."""
    load_jax_numpy(tstate.model, snapshot['params'], snapshot['batch_stats'])
    momentum, _ = from_jax_numpy(_momentum_trace(snapshot['opt_state']), {})
    for name, param in tstate.model.named_parameters():
        tstate.optimizer.state[param]['momentum_buffer'] = momentum[name].clone()
    assert tstate.step == snapshot['step']


def bench_channel_masks(params, seed=0):
    """bench.py:154-164's masks over a JAX params tree, in numpy: for every
    4-D kernel with more than 16 input channels, a random half of them
    (rounded up) kept, as a [1, 1, c, 1] mask; a 0-d one elsewhere."""
    rng = np.random.default_rng(seed)

    def mk(leaf):
        if leaf.ndim == 4 and leaf.shape[2] > 16:
            c = leaf.shape[2]
            alive = np.zeros(c, np.float32)
            alive[rng.permutation(c)[:(c + 1) // 2]] = 1.0
            return alive.reshape(1, 1, -1, 1)
        return np.ones((), np.float32)

    return jax.tree_util.tree_map(mk, params)


def _run(buckets: bool, composed: bool = False, act_bits: int = 32):
    flags = dict(SMALL, uql_use_buckets=buckets, uql_bucket_type='channel',
                 uql_activation_bits=act_bits)
    mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:1], ('data',), (1,)))
    with JFLAGS.scope(**flags), TFLAGS.scope(**flags):
        jlearner = JLearner(None, JHelper(resnet_size=50))
        tlearner = TLearner(None, THelper(resnet_size=50), device='cpu')
        jstate, jtx, _ = jlearner.init_state_quant()
        tstate, ttx, _ = tlearner.init_state_quant()
        params0 = jax.tree_util.tree_map(np.array, jax.device_get(jstate.params))
        stats0 = jax.tree_util.tree_map(np.array, jax.device_get(jstate.batch_stats))
        extra = jax.tree_util.tree_map(np.array, jax.device_get(jstate.extra))
        load_jax_numpy(tstate.model, params0, stats0)
        out = {'jax_sites': jlearner.statistics, 'port_sites': tlearner.statistics}

        # eval logits under the quant policy
        images = jlearner.dataset_eval.synthesize_arrays(16)[0][:BATCH]
        jx = jlearner.dataset_eval.augment(jnp.asarray(images), jax.random.PRNGKey(0), False)
        paths = jlearner.statistics['weight_paths']
        jeval = jax.jit(lambda v, x, w_bits, a_bits: jlearner.model_helper.forward_eval(
            jlearner.model, v, x, policy=juq.QuantPolicy(paths, w_bits, a_bits)))
        out['jax_logits'] = np.asarray(jeval(
            {'params': jstate.params, 'batch_stats': jstate.batch_stats}, jx,
            jstate.extra['w_bits'], jstate.extra['a_bits']))
        # the JAX package's own spread: images, then parameters, perturbed
        rng = np.random.default_rng(1)
        jparams = {'params': jstate.params, 'batch_stats': jstate.batch_stats}
        jnoisy = jax.tree_util.tree_map(
            lambda a: a * (1 + PERTURBATION * rng.standard_normal(a.shape)).astype(np.float32),
            jparams)
        jx_noisy = jx * (1 + PERTURBATION * rng.standard_normal(jx.shape)).astype(np.float32)
        out['jax_logits_reruns'] = [np.asarray(jeval(variables, inputs, jstate.extra['w_bits'],
                                                     jstate.extra['a_bits']))
                                    for variables, inputs in ((jparams, jx_noisy), (jnoisy, jx))]
        tx = tlearner.dataset_eval.augment(torch.from_numpy(images), None, False)
        tpolicy = tlearner._policy_fn()(tstate)
        # each activation site's input and output in the port's eval forward
        out['port_act_sites'] = sites = []
        quantize_act = tpolicy.process_act

        def recording(path, act):
            result = quantize_act(path, act)
            if path.startswith('act/'):
                sites.append((path, act.numpy().copy(), result.numpy().copy()))
            return result

        tpolicy.process_act = recording
        with torch.no_grad():
            out['port_logits'] = tlearner.model_helper.forward_eval(
                tstate.model, tx, policy=tpolicy).numpy()
        out['jax_policy'] = juq.QuantPolicy(paths, jstate.extra['w_bits'],
                                            jstate.extra['a_bits'], quant_acts=act_bits < 32)

        # train steps on the same host batches
        for learner in (jlearner, tlearner):
            _deterministic_augment(learner.dataset_train)
        arrays, labels = jlearner.dataset_train.synthesize_arrays(64)
        batches = [{'image': arrays[BATCH * i:BATCH * (i + 1)],
                    'label': labels[BATCH * i:BATCH * (i + 1)]} for i in range(NB_STEPS)]
        helper = jlearner.model_helper
        # the JAX step reports no loss: carry the CE out as a metric (adds 0)
        hooks = {}
        if composed:  # bench.py:165-173, masks from numpy into both packages
            masks = bench_channel_masks(params0)
            extra = {**extra, 'masks': masks}
            hooks = dict(grad_transform_fn=lambda g, s: jmasking.mask_gradients(
                             g, s.extra['masks']),
                         post_update_fn=lambda s: s.replace(
                             params=jmasking.apply_masks(s.params, s.extra['masks'])))
            out['masks'] = {k: v for k, v in _flat(masks).items() if v.ndim == 4}
        jstep = jlearner.build_train_step(
            jtx, policy_fn=jlearner._policy_fn(),
            loss_extra_fn=lambda s, o, i, l: (0.0, {'ce': helper.softmax_cross_entropy(l, o)}),
            **hooks)

        def jax_step(snapshot, index, image_noise=0.0, params=None):
            """One JAX step from a numpy snapshot (the step donates its
            input state, so each call builds its own)."""
            params = snapshot['params'] if params is None else params
            state = jstate.replace(
                step=jnp.asarray(snapshot['step'], jnp.int32),
                params=jax.tree_util.tree_map(jnp.asarray, params),
                batch_stats=jax.tree_util.tree_map(jnp.asarray, snapshot['batch_stats']),
                extra=jax.tree_util.tree_map(jnp.asarray, extra),
                opt_state=jax.tree_util.tree_map(jnp.asarray, snapshot['opt_state']))
            wd = float(0.5 * helper.weight_decay_loss(params))
            image = batches[index]['image'].astype(np.float32) * (1 + image_noise)
            state, m = jstep(state, {'image': jnp.asarray(image),
                                     'label': jnp.asarray(batches[index]['label'])},
                             jax.random.PRNGKey(index))
            m = {k: float(v) for k, v in jax.device_get(m).items()}
            m['loss'] = m.pop('ce') + wd
            after = jax.device_get({'params': state.params, 'batch_stats': state.batch_stats,
                                    'opt_state': state.opt_state})
            after = jax.tree_util.tree_map(np.array, after)
            after['step'] = snapshot['step'] + 1
            return m, after

        rng = np.random.default_rng(0)
        if composed:
            tmasks = {k.replace('/', '.'): torch.from_numpy(v)
                      for k, v in _flat(masks).items()}
            tstate, tstep = build_pruned_qat_step(tlearner, ttx, tstate, tmasks)
            out['port_channel_masks'] = {k: v.numpy() for k, v in
                                         channel_masks(tstate.model).items()}
            out['numpy_masks'] = {k: v.numpy() for k, v in tmasks.items()}
        else:
            tstep = tlearner.build_quant_train_step(ttx)
        snapshot = {'step': 0, 'params': params0, 'batch_stats': stats0,
                    'opt_state': jax.tree_util.tree_map(
                        np.array, jax.device_get(jlearner.init_opt_state(jtx, params0)))}
        out['steps'] = []
        for index in range(NB_STEPS):
            jm, jafter = jax_step(snapshot, index)
            noise = PERTURBATION * rng.standard_normal(batches[index]['image'].shape)
            perturbed = jax.tree_util.tree_map(
                lambda a: (a * (1 + PERTURBATION * rng.standard_normal(a.shape))
                           ).astype(np.float32), snapshot['params'])
            reruns = [jax_step(snapshot, index, image_noise=noise),
                      jax_step(snapshot, index, params=perturbed)]
            # the port's step from the same state
            _load_port_state(tstate, snapshot)
            tstate, tm = tstep(tstate, tlearner.put_batch(batches[index]), None)
            out['steps'].append({
                'start': {**_flat(snapshot['params']), **_flat(snapshot['batch_stats'])},
                'jax': (jm, {**_flat(jafter['params']), **_flat(jafter['batch_stats'])}),
                'reruns': [(m, {**_flat(a['params']), **_flat(a['batch_stats'])})
                           for m, a in reruns],
                'port': ({k: float(v) for k, v in tm.items()},
                         {**{k: v.detach().numpy().copy() for k, v in tstate.params.items()},
                          **{k: v.numpy().copy() for k, v in tstate.batch_stats.items()}})})
            if composed:  # SGD momentum of the masked kernels, after the step
                out['steps'][-1]['momentum'] = {
                    'jax': {k: v for k, v in _flat(_momentum_trace(jafter['opt_state'])).items()
                            if k in out['masks']},
                    'port': {name.replace('.', '/'): tstate.optimizer.state[p][
                        'momentum_buffer'].numpy().copy()
                        for name, p in tstate.model.named_parameters()
                        if name.replace('.', '/') in out['masks']}}
            snapshot = jafter
        out['port_step'] = tstate.step
    mesh_lib.reset_global_mesh()
    return out


def _run_small(jhelper_cls, thelper_cls, flags, learner='uniform', enbl_dst=False,
               exclude_bn=True, prepare=None, nb_steps=NB_STEPS,
               reruns=('images', 'params', 'order')):
    """NB_STEPS train steps of a small net's learner ('full-prec' or
    'uniform') against the JAX learner's, each from the JAX state, in the
    record `_run` makes (for the step checks below; the eval part is
    tests/test_torch_zoo.py's).  With `enbl_dst`, both learners distill from
    one teacher: the bridged initial parameters, each scaled by 1 + 0.05
    N(0, 1) (numpy, seed 2).  `prepare(params, images, labels)` may replace
    the initial parameters and the train images before anything runs;
    `exclude_bn` is the net's weight-decay rule; `reruns` names the JAX
    reruns whose spread sets the floor (perturbed images, perturbed
    parameters, the batch in reverse order)."""
    from pocketflow_tpu.learners.distillation_helper import DistillationHelper as JDst
    from pocketflow_tpu.learners.full_precision import FullPrecLearner as JFullPrec
    from pocketflow_tpu_torch.learners.distillation_helper import DistillationHelper as TDst
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner as TFullPrec
    mesh_lib.set_global_mesh(mesh_lib.build_mesh(jax.devices()[:1], ('data',), (1,)))
    with JFLAGS.scope(**flags), TFLAGS.scope(**flags):
        if learner == 'uniform':
            jlearner = JLearner(None, jhelper_cls())
            tlearner = TLearner(None, thelper_cls(), device='cpu')
            (jstate, jtx, _), (tstate, ttx, _) = jlearner.init_state_quant(), \
                tlearner.init_state_quant()
        else:
            jlearner = JFullPrec(None, jhelper_cls(), enbl_dst=False)
            tlearner = TFullPrec(None, thelper_cls(), device='cpu')
            (jstate, jtx, _), (tstate, ttx, _) = jlearner.init_state(), tlearner.init_state()
        params0 = jax.tree_util.tree_map(np.array, jax.device_get(jstate.params))
        stats0 = jax.tree_util.tree_map(np.array, jax.device_get(jstate.batch_stats))
        extra = jax.tree_util.tree_map(np.array, jax.device_get(jstate.extra))
        arrays, labels = jlearner.dataset_train.synthesize_arrays(64)
        if prepare is not None:
            params0, arrays, labels = prepare(params0, arrays, labels)
        load_jax_numpy(tstate.model, params0, stats0)
        out = {'port_sites': getattr(tlearner, 'statistics', None)}
        for lrn in (jlearner, tlearner):
            _deterministic_augment(lrn.dataset_train)
        batches = [{'image': arrays[BATCH * i:BATCH * (i + 1)],
                    'label': labels[BATCH * i:BATCH * (i + 1)]} for i in range(nb_steps)]
        helper = jlearner.model_helper
        jdst_fn = None
        if enbl_dst:
            rng = np.random.default_rng(2)
            teacher = jax.tree_util.tree_map(
                lambda a: (a * (1 + 0.05 * rng.standard_normal(a.shape))).astype(np.float32),
                params0)
            jdst_fn = JDst(helper, {'params': teacher, 'batch_stats': stats0}).loss_extra_fn()
            weights, buffers = from_jax_numpy(teacher, stats0)
            tlearner.helper_dst = TDst(tlearner.model_helper, 'cpu', {**weights, **buffers})
            out['teacher'] = teacher

        def jextra(s, o, i, l):  # the JAX step reports no loss: the CE as a metric
            loss, metrics = (0.0, {}) if jdst_fn is None else jdst_fn(s, o, i, l)
            return loss, {**metrics, 'ce': helper.softmax_cross_entropy(l, o)}

        policy_fn = jlearner._policy_fn() if learner == 'uniform' else None
        jstep = jlearner.build_train_step(jtx, policy_fn=policy_fn, loss_extra_fn=jextra)
        if learner == 'uniform':
            tstep = tlearner.build_quant_train_step(ttx)
        else:
            tstep = tlearner.build_train_step(
                ttx, loss_extra_fn=tlearner.helper_dst.loss_extra_fn() if enbl_dst else None)

        def jax_step(snapshot, index, image_noise=0.0, params=None, order=slice(None)):
            params = snapshot['params'] if params is None else params
            state = jstate.replace(
                step=jnp.asarray(snapshot['step'], jnp.int32),
                params=jax.tree_util.tree_map(jnp.asarray, params),
                batch_stats=jax.tree_util.tree_map(jnp.asarray, snapshot['batch_stats']),
                extra=jax.tree_util.tree_map(jnp.asarray, extra),
                opt_state=jax.tree_util.tree_map(jnp.asarray, snapshot['opt_state']))
            wd = float(helper.weight_decay_loss(params, exclude_bn=exclude_bn))
            image = batches[index]['image'].astype(np.float32) * (1 + image_noise)
            state, m = jstep(state, {'image': jnp.asarray(image[order]),
                                     'label': jnp.asarray(batches[index]['label'][order])},
                             jax.random.PRNGKey(index))
            m = {k: float(v) for k, v in jax.device_get(m).items()}
            m['loss'] = m.pop('ce') + wd + m.get('dst_loss', 0.0)
            after = jax.device_get({'params': state.params, 'batch_stats': state.batch_stats,
                                    'opt_state': state.opt_state})
            after = jax.tree_util.tree_map(np.array, after)
            after['step'] = snapshot['step'] + 1
            return m, after

        rng = np.random.default_rng(0)
        snapshot = {'step': 0, 'params': params0, 'batch_stats': stats0,
                    'opt_state': jax.tree_util.tree_map(
                        np.array, jax.device_get(jlearner.init_opt_state(jtx, params0)))}
        out['steps'] = []
        for index in range(nb_steps):
            jm, jafter = jax_step(snapshot, index)
            noise = PERTURBATION * rng.standard_normal(batches[index]['image'].shape)
            perturbed = jax.tree_util.tree_map(
                lambda a: (a * (1 + PERTURBATION * rng.standard_normal(a.shape))
                           ).astype(np.float32), snapshot['params'])
            rerun_args = {'images': dict(image_noise=noise), 'params': dict(params=perturbed),
                          'order': dict(order=slice(None, None, -1))}
            rerun_steps = [jax_step(snapshot, index, **rerun_args[name]) for name in reruns]
            _load_port_state(tstate, snapshot)
            tstate, tm = tstep(tstate, tlearner.put_batch(batches[index]), None)
            out['steps'].append({
                'start': {**_flat(snapshot['params']), **_flat(snapshot['batch_stats'])},
                'jax': (jm, {**_flat(jafter['params']), **_flat(jafter['batch_stats'])}),
                'reruns': [(m, {**_flat(a['params']), **_flat(a['batch_stats'])})
                           for m, a in rerun_steps],
                'port': ({k: float(v) for k, v in tm.items()},
                         {**{k: v.detach().numpy().copy() for k, v in tstate.params.items()},
                          **{k: v.numpy().copy() for k, v in tstate.batch_stats.items()}})})
            snapshot = jafter
        out['port_step'] = tstate.step
        out['batches'], out['params0'] = batches, params0
    mesh_lib.reset_global_mesh()
    return out


def _tolerance(want, floor):
    """The bound on ||port - jax|| for one tensor (or one scalar metric)."""
    return float(np.linalg.norm(ATOL + RTOL * np.abs(want))) + NOISE_FACTOR * floor


def _floor(step, key, idx):
    want = step['jax'][idx][key]
    return max(float(np.linalg.norm(np.asarray(r[idx][key] - want))) for r in step['reruns'])


def test_quant_sites_match(run):
    jsites, tsites = run['jax_sites'], run['port_sites']
    assert tsites['weight_paths'] == jsites['weight_paths']
    assert tsites['weight_shapes'] == [tuple(s) for s in jsites['weight_shapes']]
    assert (tsites['nb_matmuls'], tsites['nb_activations']) == (52, 49)
    assert jsites['nb_activations'] == 49


def test_eval_logits_match(run):
    np.testing.assert_allclose(run['port_logits'], run['jax_logits'], rtol=1e-3, atol=1e-3)


def test_eval_logits_within_the_reference_spread(run):
    """The eval logits under the slice's bound: ||port - jax|| <= ||ATOL +
    RTOL*|jax||| + NOISE_FACTOR * the larger ||rerun - jax|| of two JAX
    evals, one with the images and one with the parameters perturbed by
    1e-7 relative."""
    want = run['jax_logits']
    floor = max(float(np.linalg.norm(r - want)) for r in run['jax_logits_reruns'])
    err = float(np.linalg.norm(run['port_logits'] - want))
    assert err <= _tolerance(want, floor), (err, _tolerance(want, floor), floor)


def _nhwc(a):
    """A port activation (NCHW) in the JAX package's layout (NHWC)."""
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def test_activation_sites_quantize_as_the_reference(run):
    """Each of the 49 activation sites of the port's eval forward returns,
    bit for bit, what the JAX package's QuantPolicy.process_act returns on
    the same input: the site's quantization, level for level, apart from the
    chaos of the whole network (which moves the inputs, not this map)."""
    sites = run['port_act_sites']
    assert [path for path, _, _ in sites] == ['act/%d' % i for i in range(49)]
    policy = run['jax_policy']
    for path, act, got in sites:
        want = np.asarray(policy.process_act(path, jnp.asarray(_nhwc(act))))
        np.testing.assert_array_equal(_nhwc(got), want, err_msg=path)


def test_train_loss_and_metrics_match(run):
    assert run['port_step'] == NB_STEPS
    for index, step in enumerate(run['steps']):
        jm, tm = step['jax'][0], step['port'][0]
        assert set(tm) == set(jm)
        for key in jm:
            bound = _tolerance(jm[key], _floor(step, key, 0))
            assert abs(tm[key] - jm[key]) <= bound, (index, key, tm[key], jm[key], bound)


def _check_state(run, kind):
    """kind: 'params' (kernels, biases, BN scales) or 'stats' (BN mean/var)."""
    for index, step in enumerate(run['steps']):
        want, got = step['jax'][1], step['port'][1]
        assert set(got) == set(want)
        for key in want:
            if (key.endswith('/mean') or key.endswith('/var')) != (kind == 'stats'):
                continue
            err = float(np.linalg.norm(got[key] - want[key]))
            bound = _tolerance(want[key], _floor(step, key, 1))
            assert err <= bound, (index, key, err, bound)


def test_params_after_two_steps_match(run):
    _check_state(run, 'params')


def test_batch_stats_after_two_steps_match(run):
    _check_state(run, 'stats')


def test_two_steps_move_parameters_past_the_tolerance(run):
    """The comparisons above would catch a wrong update: in each step at
    least 90% of the tensors (parameters and BN statistics) move by more
    than the bound they are held to (measured: 94-96%; the rest are deep BN
    scales, whose gradients are small), and almost none move by less than
    the JAX package's own spread (measured: none, the smallest movement is
    7x its spread)."""
    for index, step in enumerate(run['steps']):
        start, want = step['start'], step['jax'][1]
        moved, below_floor = [], []
        for key in want:
            movement = float(np.linalg.norm(want[key] - start[key]))
            floor = _floor(step, key, 1)
            if movement > _tolerance(want[key], floor):
                moved.append(key)
            if movement <= floor:
                below_floor.append(key)
        assert len(moved) >= 0.9 * len(want), (index, len(moved), len(want))
        assert len(below_floor) <= 0.01 * len(want), (index, below_floor)


def _update(step, after):
    """One step's update of all parameters, as one float64 vector."""
    return np.concatenate([(after[key] - step['start'][key]).ravel().astype(np.float64)
                           for key in sorted(step['start'])
                           if not (key.endswith('/mean') or key.endswith('/var'))])


def test_update_has_the_reference_size(run):
    """Over all parameters together, the port's update projected on the JAX
    update, <d_port, d_jax> / <d_jax, d_jax>, is 1 within NOISE_FACTOR times
    the JAX reruns' own departure from 1, plus 1e-3 (measured: the port
    within 0.0032 of 1, the reruns within 0.0046).  A learning rate or a
    momentum that is off by 2% fails here, though it can pass the
    per-tensor bounds."""
    for index, step in enumerate(run['steps']):
        want = _update(step, step['jax'][1])
        norm2 = want @ want

        def ratio(after):
            return _update(step, after) @ want / norm2

        spread = max(abs(ratio(r[1]) - 1.0) for r in step['reruns'])
        got = ratio(step['port'][1])
        assert abs(got - 1.0) <= NOISE_FACTOR * spread + 1e-3, (index, got, spread)
