"""A QAT step with 8-bit activations held to the JAX learner's in a regime
with no level flips, where a learning rate 5% off and a Nesterov update fail.

The act8 slice (tests/test_torch_qat_slice_act8.py) is chaotic: an 8-bit
level a rounding away from its edge flips between the two frameworks' sum
orders, and its bound (the JAX reruns' spread) is wide enough to pass a
learning rate 5% off.

Here every activation is an integer number of u = 1/32, from 0 to exactly
255 u, so each site's range is 255 u and its levels are the multiples of u:
the fake-quant (its min/max, the select, the kernel's arithmetic) maps each
activation to itself, and every sum before it is exact in fp32.  The
forwards of the port and of the JAX package are then equal bit for bit (op
by op; in the JAX train step, where XLA evaluates the same formula with other
roundings, within an ulp of a level, far from any edge), and the step's
differences are its backward's rounding.  The weights stay at 32 bits: the
JAX train step's 4-bit fake-quant puts a kernel's 0 level at 4.8e-7 (its
op-by-op formula and the port's at 0), which over fc3's 3.2M mostly-zero
weights moves the logits by 3e-3.

The regime: ConvNet @ FMNIST (no BN), 8-bit activations, fp32, batch 8, one
step from the bridged state (learning rate 0.1):
* images of 0 and 255 only (x/255 is 0 or 1), with a white 12x12 block in
  each batch's first image;
* conv1 in steps of 1/32: channel 0's taps are positive and sum to 255/32,
  which the block reaches; the others' positive taps sum to less; the last
  channel's taps are negative (always 0 after the relu);
* conv2 and fc3 with integer taps: each output has one tap of 1 on a live
  input and no other, so none passes 255 u, and output 0's tap sits where
  the block's channel 0 reaches 255 u; conv2's last channel has no tap, so
  it is always 0;
* fc4 as initialized; no quantization follows it.
The floor is one JAX rerun: the same batch in reverse order (the same
function with its sums in another order).  Perturbing the images or the
parameters by 1e-7 would break the exact sums the regime is built on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_slice_parity import (
    RTOL, _check_state, _floor, _run_small, _tolerance, _update, NOISE_FACTOR)

FLAGS = dict(batch_size=8, batch_size_eval=8, nb_smpls_train=64, nb_smpls_eval=16,
             compute_dtype='float32', synthetic_data=True, rand_seed=0,
             uql_weight_bits=32, uql_activation_bits=8, uql_use_buckets=False,
             # the QAT rate is 1e-3 * lrn_rate_init * batch / 128: 0.1
             lrn_rate_init=1600.0)
UNIT = 1 / 32  # of every activation site


def _one_tap(rng, nb_inputs, nb_outputs, live, anchor):
    """Integer taps [nb_inputs, nb_outputs]: a 1 per output on a live input
    (output 0's at `anchor`), 0 elsewhere."""
    taps = np.zeros((nb_inputs, nb_outputs), np.int64)
    rows = rng.choice(np.flatnonzero(live), nb_outputs)
    rows[0] = anchor
    taps[rows, np.arange(nb_outputs)] = 1
    return taps


def exact_regime(params, images, labels, seed=0):
    """Replace the bridged parameters and the images by the regime's (the
    taps -8 and 7 on inputs that are always 0 keep the kernels on a 4-bit
    grid, which a 4-bit fake-quant maps to itself op by op)."""
    rng = np.random.default_rng(seed)
    images = np.where(rng.random(images.shape) < 0.5, 255, 0).astype(np.uint8)
    images[::8, 8:20, 8:20, :] = 255  # each batch's white block
    conv1 = rng.integers(-32, 28, (3, 3, 1, 32)).astype(np.float64)
    conv1[:, :, :, 0] = np.array([28] * 8 + [31]).reshape(3, 3, 1)
    conv1[:, :, :, 31] = -rng.integers(1, 32, (3, 3, 1))
    # conv2: taps as [3*3*32, 64] in HWIO order; channel 0 of act/0 at the
    # centre tap is the anchor; input channel 31 (act/0's dead one) is not live
    live = np.tile(np.arange(32) < 31, 9)
    conv2 = _one_tap(rng, 288, 64, live, anchor=4 * 32 + 0)
    conv2[:, 63] = 0  # the dead output channel
    conv2[31, 1], conv2[63, 1] = -8, 7
    # fc3: inputs in H, W, C order of act/1 pooled to 7x7; (3, 3, 0) is the
    # anchor, which the block reaches; channel 63 is never live
    live = np.tile(np.arange(64) < 63, 49)
    fc3 = _one_tap(rng, 3136, 1024, live, anchor=(3 * 7 + 3) * 64 + 0)
    fc3[63, 1], fc3[127, 1] = -8, 7
    params = jax.tree_util.tree_map(np.array, params)
    for name, kernel in (('conv1', conv1 / 32), ('conv2', conv2.reshape(3, 3, 32, 64)),
                         ('fc3', fc3)):
        params[name]['kernel'] = kernel.astype(np.float32)
        params[name]['bias'] = np.zeros_like(params[name]['bias'])
    return params, images, labels


@pytest.fixture(scope='module')
def run():
    from pocketflow_tpu.nets.convnet_at_fmnist import ModelHelper as JHelper
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper as THelper
    return _run_small(JHelper, THelper, FLAGS, exclude_bn=False, prepare=exact_regime,
                      nb_steps=1, reruns=('order',))


def _sites(run):
    """Each activation site (path, input, output) of the step's forward in
    both packages, on the step's batch and parameters."""
    import torch
    from pocketflow_tpu.config import FLAGS as JFLAGS
    from pocketflow_tpu.learners.uniform_quantization import utils as juq
    from pocketflow_tpu.nets.convnet_at_fmnist import ModelHelper as JHelper
    from pocketflow_tpu.nn.layers import compression as jcompression
    from pocketflow_tpu_torch.config import FLAGS as TFLAGS
    from pocketflow_tpu_torch.core.bridge import load_jax_numpy
    from pocketflow_tpu_torch.learners.uniform_quantization import utils as tuq
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper as THelper
    from pocketflow_tpu_torch.nn.layers import compression as tcompression
    params, batch = run['params0'], run['batches'][0]
    paths = run['port_sites']['weight_paths']
    w_bits, a_bits = np.full(2, 4.0, np.float32), np.full(3, 8.0, np.float32)
    out = {}
    with JFLAGS.scope(**FLAGS), TFLAGS.scope(**FLAGS):
        jhelper, thelper = JHelper(), THelper()
        jpolicy = juq.QuantPolicy(paths, jnp.asarray(w_bits), jnp.asarray(a_bits))
        tmodel = thelper.create_model()
        load_jax_numpy(tmodel, params, {})
        tpolicy = tuq.QuantPolicy(paths, torch.from_numpy(w_bits), torch.from_numpy(a_bits),
                                  tuq.quant_weights(tmodel, paths))
        for name, policy in (('jax', jpolicy), ('port', tpolicy)):
            sites, quantize = [], policy.process_act

            def recording(path, act, sites=sites, quantize=quantize, port=name == 'port'):
                result = quantize(path, act)
                if path.startswith('act/'):
                    def nhwc(a):
                        a = np.asarray(a.detach() if port else a)
                        return a.transpose(0, 2, 3, 1) if port and a.ndim == 4 else a
                    sites.append((path, nhwc(act), nhwc(result)))
                return result

            policy.process_act = recording
            out[name] = sites
        x = batch['image'].astype(np.float32) / 255.0
        with jcompression(jpolicy):
            jhelper.create_model().apply({'params': params}, jnp.asarray(x), train=True)
        with tcompression(tpolicy):
            tmodel(torch.from_numpy(x))
    return out


def test_the_forward_has_no_level_flips(run):
    """Every activation site's input and output are equal in the two
    packages, bit for bit; act/0 and act/1 reach their anchors."""
    sites = _sites(run)
    assert [p for p, _, _ in sites['port']] == [p for p, _, _ in sites['jax']] == \
        ['act/0', 'act/1', 'act/2']
    for (path, jin, jout), (_, tin, tout) in zip(sites['jax'], sites['port']):
        np.testing.assert_array_equal(tin, jin, err_msg=path)
        np.testing.assert_array_equal(tout, jout, err_msg=path)
        # many levels taken, the largest 255 units, each activation on its level
        assert float(jin.max()) == 255 * UNIT and len(np.unique(jin)) > 16, path
        np.testing.assert_array_equal(jout, jin, err_msg=path)


def test_step_loss_and_metrics_match(run):
    step = run['steps'][0]
    jm, tm = step['jax'][0], step['port'][0]
    assert set(tm) == set(jm) and run['port_step'] == 1
    for key in jm:
        bound = _tolerance(jm[key], _floor(step, key, 0))
        assert abs(tm[key] - jm[key]) <= bound, (key, tm[key], jm[key], bound)


def test_params_after_the_step_match(run):
    _check_state(run, 'params')


def test_every_tensor_moves_past_its_bound(run):
    step = run['steps'][0]
    for key, want in step['jax'][1].items():
        movement = float(np.linalg.norm(want - step['start'][key]))
        assert movement > 10 * _tolerance(want, _floor(step, key, 1)), key


def test_update_has_the_reference_size(run):
    """<d_port, d_jax> / <d_jax, d_jax> within 2x the reordered rerun's
    departure from 1 plus 1e-3: a learning rate 5% off is 50 times that."""
    step = run['steps'][0]
    want = _update(step, step['jax'][1])
    ratio = lambda after: _update(step, after) @ want / (want @ want)  # noqa: E731
    spread = abs(ratio(step['reruns'][0][1]) - 1.0)
    got = ratio(step['port'][1])
    assert spread < RTOL and abs(got - 1.0) <= NOISE_FACTOR * spread + 1e-3, (got, spread)
