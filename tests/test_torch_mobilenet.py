"""The port's MobileNet-v1/v2 (pocketflow_tpu_torch/nets/mobilenet.py) against
the JAX nets on the CPU, in fp32, parameters carried across by the bridge
(BN variables moved off their init):

* eval logits of both versions within 1e-5 relative (atol 1e-5 of the
  largest logit), at depth multipliers 0.25 and 0.5 on 64x64 images;
* `_depth` equal on a grid of widths and multipliers;
* `PFDepthwiseConv` against Flax's at stride 1 and 2 on odd and even sizes
  ('SAME': the extra row and column at the end), its initializer's fan_out;
  `avg_pool` against Flax's, 'SAME' (zeros counted) and 'VALID';
* the quant sites: MobileNet-v1 with all layers has 28 weights (stem, 13
  depthwise, 13 pointwise, logits) and 27 relu6 sites, the same paths and
  shapes as the JAX net's; v2's equal the JAX net's too;
* one full-precision train step of MobileNet-v1 @ 64, depth 0.5, batch 8,
  from the bridged JAX state, within the slice bound of
  tests/torch_slice_parity.py (rtol 1e-4, atol 1e-5 plus 2x the JAX reruns'
  spread); both versions under `--remat_blocks=full` give the gradients of
  'none' bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu.learners.uniform_quantization import utils as juq
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core.bridge import load_jax_numpy
from pocketflow_tpu_torch.learners.uniform_quantization import utils as tuq
from pocketflow_tpu_torch.nn import layers as tl
from torch_slice_parity import (  # noqa: F401  (collected here)
    BATCH, _run_small, test_batch_stats_after_two_steps_match, test_params_after_two_steps_match,
    test_train_loss_and_metrics_match, test_update_has_the_reference_size)

torch.set_num_threads(2)
IMAGE = 64
# MobileNet @ ILSVRC-12 at half the widths, 64x64 images, batch 8, fp32;
# the full-precision rate lrn_rate_init * 8 / 128 = 0.1.  At a quarter of
# the widths blocks 9-12 sit at 4x4 with half their activations 0, and the
# JAX package's fp32 step lands 10% of the gradient away from a float64
# evaluation there (its BN variance is E[x^2] - E[x]^2), the port 3e-5
MOBILENET_SMALL = dict(ilsvrc_image_size=IMAGE, mobilenet_depth_mult=0.5, batch_size=BATCH,
                       batch_size_eval=BATCH, nb_smpls_train=64, nb_smpls_eval=16,
                       compute_dtype='float32', synthetic_data=True, rand_seed=0,
                       lrn_rate_init=1.6,
                       # the JAX step reports no loss: _run_small adds the weight decay at
                       # the default coefficient, MobileNet's 0.5 * 4e-5
                       loss_w_dcy=0.5 * 4e-5)


def mobilenets(version, depth_mult):
    from pocketflow_tpu.nets import mobilenet as jm
    from pocketflow_tpu_torch.nets import mobilenet as tm
    cls = {1: 'MobileNetV1', 2: 'MobileNetV2'}[version]
    return (getattr(jm, cls)(nb_classes=1001, depth_mult=depth_mult, dtype=jnp.float32),
            getattr(tm, cls)(nb_classes=1001, depth_mult=depth_mult, dtype=torch.float32))


def setup(version, depth_mult, seed=0, batch=2):
    """(JAX module, variables, port module loaded with them, NHWC images)."""
    x = (np.random.default_rng(seed).normal(size=(batch, IMAGE, IMAGE, 3))).astype(np.float32)
    jm, tm = mobilenets(version, depth_mult)
    variables = jax.device_get(jax.jit(lambda v: jm.init(jax.random.PRNGKey(seed), v,
                                                           train=False))(jnp.asarray(x)))
    rng = np.random.default_rng(seed + 1)

    def moved(path, leaf):  # biases, BN scales and statistics off their init
        leaf = np.asarray(leaf)
        if path[-1].key in ('bias', 'scale', 'mean'):
            return leaf + 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == 'var':
            return leaf * (1 + 0.2 * rng.random(leaf.shape)).astype(np.float32)
        return leaf

    variables = jax.tree_util.tree_map_with_path(moved, variables)
    load_jax_numpy(tm, variables['params'], variables['batch_stats'])
    tm.eval()
    return jm, variables, tm, x


@pytest.mark.parametrize('version,depth_mult', [(1, 0.25), (1, 0.5), (2, 0.25), (2, 0.5)])
def test_eval_logits_match_jax(version, depth_mult):
    jm, variables, tm, x = setup(version, depth_mult)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables,
                                                                          jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1001) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('channels', [8, 16, 24, 32, 64, 96, 160, 320, 1024, 1280])
def test_depth_matches_jax(channels):
    from pocketflow_tpu.nets.mobilenet import _depth as jdepth
    from pocketflow_tpu_torch.nets.mobilenet import _depth as tdepth
    for mult in (0.25, 0.35, 0.5, 0.75, 1.0, 1.3, 1.4):
        assert tdepth(channels, mult) == jdepth(channels, mult), (channels, mult)


@pytest.mark.parametrize('stride,size', [(1, 7), (1, 8), (2, 7), (2, 8)])
def test_depthwise_same_padding_matches_flax(stride, size):
    from pocketflow_tpu.nn import layers as jl
    x = np.random.default_rng(size).normal(size=(2, size, size, 6)).astype(np.float32)
    jconv = jl.PFDepthwiseConv((3, 3), (stride, stride), dtype=jnp.float32)
    variables = jax.device_get(jconv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    tconv = tl.PFDepthwiseConv(6, (3, 3), (stride, stride), dtype=torch.float32)
    load_jax_numpy(tconv, variables['params'], {})
    got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, -(-size // stride), -(-size // stride), 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # Flax's variance_scaling(2.0, 'fan_out') reads fan_out as 9 * channels
    # for a (3, 3, 1, C) kernel: the truncated normal's std is sqrt(2 / 9C)
    wide = tl.PFDepthwiseConv(512, dtype=torch.float32)
    wide.reset_parameters(torch.Generator().manual_seed(0))
    assert abs(float(wide.kernel.detach().std()) / np.sqrt(2.0 / (9 * 512)) - 1) < 0.05


@pytest.mark.parametrize('padding,size', [('SAME', 7), ('SAME', 8), ('VALID', 7)])
def test_avg_pool_matches_flax(padding, size):
    """3x3 stride-2 average pooling; 'SAME' pads with zeros that count."""
    from pocketflow_tpu.nn import layers as jl
    x = np.random.default_rng(size).normal(size=(2, size, size, 5)).astype(np.float32)
    want = np.asarray(jl.avg_pool(jnp.asarray(x), (3, 3), (2, 2), padding))
    got = tl.avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), (3, 3), (2, 2), padding)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('version,sites', [(1, (28, 27)), (2, (53, 35))])
def test_quant_sites_match_jax(version, sites):
    jm, variables, tm, x = setup(version, 0.25, batch=1)
    with JFLAGS.scope(uql_quantize_all_layers=True), TFLAGS.scope(uql_quantize_all_layers=True):
        jsites = juq.discover_quant_sites(jm, variables, jnp.asarray(x))
        tsites = tuq.discover_quant_sites(tm, torch.from_numpy(x))
    assert tsites['weight_paths'] == jsites['weight_paths']
    assert tsites['weight_shapes'] == [tuple(s) for s in jsites['weight_shapes']]
    assert (tsites['nb_matmuls'], tsites['nb_activations']) == sites
    assert jsites['nb_activations'] == sites[1]
    if version == 1:
        assert tsites['weight_paths'][:3] == ['conv_init', 'block01/dw', 'block01/pw']
        assert tsites['weight_shapes'][1] == (3, 3, 1, 8) and tsites['weight_paths'][-1] == 'logits'


def test_remat_blocks_refused():
    """No longer refused: v1 and v2 build under --remat_blocks=full, every
    block marked, and give 'none''s gradients bit for bit."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, IMAGE, IMAGE, 3)).astype(
        np.float32))
    for version in (1, 2):
        grads = []
        for mode in ('none', 'full'):
            with TFLAGS.scope(remat_blocks=mode):
                model = mobilenets(version, 0.25)[1]
            assert {m.remat for m in model.modules() if isinstance(m, tl.RematBlock)} == {mode}
            tl.reset_parameters(model, torch.Generator().manual_seed(version))
            (model.train()(x) ** 2).sum().backward()
            grads.append({k: p.grad for k, p in model.named_parameters()})
        assert all(torch.equal(grads[1][k], v) for k, v in grads[0].items())


@pytest.fixture(scope='module')
def run():
    from pocketflow_tpu.nets.mobilenet_at_ilsvrc12 import ModelHelper as JHelper
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper as THelper
    return _run_small(JHelper, THelper, MOBILENET_SMALL, learner='full-prec')


def test_step_runs_mobilenet_v1(run):
    assert run['port_step'] == 2
    assert 'block13/bn_pw/bn/mean' in run['steps'][0]['port'][1]
