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
"""

import numpy as np
import pytest
import torch

from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from torch_slice_parity import BATCH, _check_state, _floor, _tolerance, _update

torch.set_num_threads(2)
NB_STEPS = 8
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
