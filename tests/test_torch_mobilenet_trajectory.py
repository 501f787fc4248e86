"""The MobileNet-v1 full-precision learner held against the JAX learner's
over NB_STEPS train steps along JAX's trajectory, on the CPU in fp32, in
the regime of the parity harness's MobileNet-v1 strip (the hard synthetic
task at its snr, 64 classes, depth multiplier 0.5, the strip's rate per
sample), cut to 64x64 images at batch 8.

tests/test_torch_mobilenet.py holds two steps on the blobs task; here each
of eight steps starts from the JAX state after the one before
(tests/torch_slice_parity.py:_run_small), so every update along the way is
held: the step's loss and metrics and every parameter and BN statistic
after it within the slice bound (rtol 1e-4, atol 1e-5 plus 2x the spread of
JAX reruns with the images or the parameters perturbed by 1e-7 relative, or
the batch reversed), the update over all parameters of the JAX update's
size, and most tensors moved past their bound (so a wrong update shows).

Free-running trajectories are no test here: at this size JAX's own 1e-7
reruns drift as far from each other within a few steps as the steps move
the parameters.

The strip itself runs in bf16, so the same eight steps run again at
--compute_dtype=bfloat16, JAX bf16 against the port bf16, both on the CPU.
There a perturbation of 1e-7 rounds away at the first cast, and the reruns'
spread would read 0; the reruns are perturbed at bf16's own resolution
instead, 2^-8 relative (half a bf16 ulp at the top of a binade, so about
half of the perturbed values round to a neighbour), the parameters' rerun
with its perturbation taken back out after the step (it is as large as an
update), and each tensor is held within rtol 1e-4, atol 1e-5 plus 2x that
spread, as in fp32.  Beside the
steps, the dtype that goes into and comes out of every module of one bf16
train forward equals JAX's: the stem conv, each depthwise and pointwise
conv, each BN, each block (whose input and output are relu6's), the
classifier's input (the global average pool's output) and output, the
model's output and the loss.
"""

import numpy as np
import pytest
import torch

from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from torch_slice_parity import BATCH, _check_state, _floor, _tolerance, _update

torch.set_num_threads(2)
NB_STEPS = 8
BF16_PERTURBATION = 2.0 ** -8
STRIP = dict(ilsvrc_image_size=64, mobilenet_depth_mult=0.5, mobilenet_version=1,
             batch_size=BATCH, batch_size_eval=BATCH, nb_smpls_train=NB_STEPS * BATCH,
             nb_smpls_eval=16, compute_dtype='float32', synthetic_data=True,
             synthetic_task='hard', synthetic_snr=0.15, nb_classes=64, rand_seed=0,
             lrn_rate_init=0.1,  # the strip's rate a sample: 0.1 x 8 / 128 at batch 8
             loss_w_dcy=0.5 * 4e-5)  # _run_small adds MobileNet's weight decay


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


@pytest.fixture(scope='module')
def run():
    from pocketflow_tpu.nets.mobilenet_at_ilsvrc12 import ModelHelper as JHelper
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper as THelper
    from torch_slice_parity import _run_small
    return _run_small(JHelper, THelper, STRIP, learner='full-prec', nb_steps=NB_STEPS)


def test_each_step_loss_and_metrics_match(run):
    assert run['port_step'] == len(run['steps']) == NB_STEPS
    for index, step in enumerate(run['steps']):
        jm, tm = step['jax'][0], step['port'][0]
        assert set(tm) == set(jm)
        for key in jm:
            bound = _tolerance(jm[key], _floor(step, key, 0))
            assert abs(tm[key] - jm[key]) <= bound, (index, key, tm[key], jm[key], bound)


@pytest.mark.parametrize('kind', ['params', 'stats'])
def test_each_step_state_matches(run, kind):
    _check_state(run, kind)


def test_each_update_has_the_reference_size(run):
    """<d_port, d_jax> / <d_jax, d_jax> is 1 within 2x the reruns' own
    departure from 1, plus 1e-3, at every step."""
    for index, step in enumerate(run['steps']):
        want = _update(step, step['jax'][1])
        norm2 = want @ want

        def ratio(after):
            return _update(step, after) @ want / norm2

        spread = max(abs(ratio(r[1]) - 1.0) for r in step['reruns'])
        got = ratio(step['port'][1])
        assert abs(got - 1.0) <= 2.0 * spread + 1e-3, (index, got, spread)


def test_the_steps_move_most_tensors_past_their_bound(run):
    for index, step in enumerate(run['steps']):
        start, want = step['start'], step['jax'][1]
        moved = [key for key in want if float(np.linalg.norm(want[key] - start[key]))
                 > _tolerance(want[key], _floor(step, key, 1))]
        assert len(moved) >= 0.8 * len(want), (index, len(moved), len(want))


# ---------------------------------------------------------------------------
# the strip's own dtype: bf16
# ---------------------------------------------------------------------------

STRIP_BF16 = dict(STRIP, compute_dtype='bfloat16')


@pytest.fixture(scope='module')
def run_bf16():
    from pocketflow_tpu.nets.mobilenet_at_ilsvrc12 import ModelHelper as JHelper
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper as THelper
    from torch_slice_parity import _run_small
    return _run_small(JHelper, THelper, STRIP_BF16, learner='full-prec', nb_steps=NB_STEPS,
                      perturbation=BF16_PERTURBATION, rebase_params=True)


def test_bf16_each_step_loss_and_metrics_match(run_bf16):
    test_each_step_loss_and_metrics_match(run_bf16)


@pytest.mark.parametrize('kind', ['params', 'stats'])
def test_bf16_each_step_state_matches(run_bf16, kind):
    _check_state(run_bf16, kind)


def test_bf16_each_update_has_the_reference_size(run_bf16):
    test_each_update_has_the_reference_size(run_bf16)


def test_bf16_steps_move_every_bn_statistic_past_its_bound(run_bf16):
    """In bf16 a kernel's update is as noisy as it is large: JAX's reruns
    (the batch reversed, unperturbed, among them) land 30-110% of a step's
    movement from each other, so most kernels stay inside 2x that spread.
    The forward's statistics do not: at every step at least 95% of the 54
    BN means and variances move past their bound (measured: 53 or 54 of
    them, and 54-59 of all 137 tensors), so a cast that changes the forward
    shows there, and the update's size above holds the kernels together."""
    for index, step in enumerate(run_bf16['steps']):
        start, want = step['start'], step['jax'][1]
        stats = [key for key in want if key.endswith('/mean') or key.endswith('/var')]
        assert len(stats) == 54
        still = [key for key in stats if float(np.linalg.norm(want[key] - start[key]))
                 <= _tolerance(want[key], _floor(step, key, 1))]
        assert len(still) <= 0.05 * len(stats), (index, still)


def _jax_module_dtypes(images, labels):
    """{Flax path: (input dtype, output dtype)} of every module call in one
    bf16 train forward of the JAX net, the model's output and the loss's
    dtype, and the initial variables."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from pocketflow_tpu.config import FLAGS as JFLAGS
    from pocketflow_tpu.nets.mobilenet_at_ilsvrc12 import ModelHelper as JHelper
    with JFLAGS.scope(**STRIP_BF16):
        helper = JHelper()
        model = helper.create_model()
        x = jnp.asarray(images, jnp.float32)
        variables = model.init(jax.random.PRNGKey(0), x, train=False)
        seen = {}

        def interceptor(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if context.method_name == '__call__':
                seen['/'.join(context.module.path)] = (str(args[0].dtype), str(out.dtype))
            return out

        with nn.intercept_methods(interceptor):
            logits, _ = model.apply(variables, x, train=True, mutable=['batch_stats'])
        loss, _ = helper.calc_loss(jnp.asarray(labels), logits, variables['params'])
    return seen, str(logits.dtype), str(loss.dtype), variables


def _port_module_dtypes(images, labels, variables):
    """The same record of the port's net, from the same variables."""
    from pocketflow_tpu_torch.core.bridge import load_jax_numpy
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper as THelper
    with TFLAGS.scope(**STRIP_BF16):
        helper = THelper()
        model = helper.create_model()
        load_jax_numpy(model, jax_tree(variables['params']), jax_tree(variables['batch_stats']))
        seen = {}

        def hook(name):
            def record(module, args, out):
                seen[name.replace('.', '/')] = (_jax_name(args[0].dtype), _jax_name(out.dtype))
            return record

        for name, module in model.named_modules():
            if name:
                module.register_forward_hook(hook(name))
        model.train()
        logits = model(torch.from_numpy(images))
        loss, _ = helper.calc_loss(torch.from_numpy(labels), logits,
                                   list(model.named_parameters()))
    return seen, _jax_name(logits.dtype), _jax_name(loss.dtype)


def jax_tree(tree):
    import jax
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _jax_name(dtype):
    return {torch.bfloat16: 'bfloat16', torch.float32: 'float32'}[dtype]


def test_bf16_module_dtypes_match_jax():
    """Every module of the port's bf16 train forward takes and returns the
    dtype that the same module of JAX's takes and returns (the port's BN has
    no inner module: JAX's 'bn' under each BN is its Flax nn.BatchNorm)."""
    rng = np.random.default_rng(0)
    images = rng.uniform(0.0, 1.0, (BATCH, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 64, BATCH)
    jseen, jout, jloss, variables = _jax_module_dtypes(images, labels)
    tseen, tout, tloss = _port_module_dtypes(images, labels, variables)
    assert tseen == {path: dtypes for path, dtypes in jseen.items()
                     if path and not path.endswith('/bn')}
    kinds = {path.rsplit('/', 1)[-1] for path in tseen}
    assert {'conv_init', 'bn_init', 'dw', 'bn_dw', 'pw', 'bn_pw', 'logits'} <= kinds
    # the blocks' relu6 outputs and the pool's output (the classifier's input)
    # stay in bf16; the logits come out of the net, and the loss, in fp32
    assert tseen['block13'] == ('bfloat16', 'bfloat16')
    assert tseen['logits'] == ('bfloat16', 'bfloat16')
    assert (tout, tloss) == (jout, jloss) == ('float32', 'float32')
