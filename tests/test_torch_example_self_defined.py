"""The port's bring-your-own-model tutorial
(pocketflow_tpu_torch/examples/self_defined_convnet.py) against the JAX
package's (examples/self_defined_convnet.py, imported by path as
tests/test_entry_points.py imports it), on the CPU:

* the port's example trains under the JAX test's settings
  (nb_epochs_rat=0.01, lrn_rate_init=0.05) and returns a state; its main()
  trains, saves and evaluates;
* from the JAX example's parameters, carried across by the bridge, the eval
  forward equals the JAX example's, and two full-precision train steps
  (each from the JAX state; 16x16, batch 8, fp32, synthetic data, the
  learning rate 0.1) equal the JAX steps within the slice tests' bound
  (tests/torch_slice_parity.py: rtol 1e-4, atol 1e-5 plus 2x the spread of
  JAX reruns), each moving the parameters past it.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core.bridge import load_jax_numpy
from pocketflow_tpu_torch.examples import self_defined_convnet as texample
from pocketflow_tpu_torch.main import register_flags

from torch_slice_parity import (  # noqa: F401  (collected here)
    BATCH, CIFAR_SMALL, PERTURBATION, _run_small, _tolerance,
    test_params_after_two_steps_match, test_train_loss_and_metrics_match,
    test_two_steps_move_parameters_past_the_tolerance, test_update_has_the_reference_size)

register_flags()  # main()'s flags, so that each test's scope restores them
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(CIFAR_SMALL, lrn_rate_init=1.6)  # 1.6 * 8 / 128 = 0.1


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        'jax_self_defined_convnet', os.path.join(REPO, 'examples', 'self_defined_convnet.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def test_port_example_trains_and_returns_a_state(tmp_path):
    with TFLAGS.scope(nb_epochs_rat=0.01, lrn_rate_init=0.05,
                      save_path=str(tmp_path / 'models' / 'model.ckpt')):
        learner = texample.create_learner(None, texample.ModelHelper(), device='cpu')
        state = learner.train()
    assert state is not None and state.step == int(2048 * 30 * 0.01 / 32)
    assert all(torch.isfinite(p).all() for p in state.params.values())


def test_port_example_main_trains_then_evaluates(tmp_path):
    flags = ['--nb_epochs_rat=0.005', '--lrn_rate_init=0.05', '--synthetic_data',
             '--save_path=%s' % (tmp_path / 'models' / 'model.ckpt'),
             '--log_dir=%s' % (tmp_path / 'logs')]
    learner = texample.main(flags, device='cpu')
    assert learner.device == torch.device('cpu')
    assert os.path.exists(tmp_path / 'models' / 'checkpoint.json')
    texample.main(flags + ['--exec_mode=eval'], device='cpu')
    with pytest.raises(SystemExit, match='unrecognized'):
        texample.main(['--no_such_flag=1'], device='cpu')


def test_forward_from_jax_parameters_matches_jax():
    jexample = _jax_example()
    images = np.random.default_rng(0).random((BATCH, 16, 16, 1)).astype(np.float32)
    jmodel = jexample.ModelHelper().create_model()
    variables = jax.device_get(jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(images), train=False))())
    params = jax.tree_util.tree_map(np.array, variables['params'])

    def jax_logits(p, x):
        return np.asarray(jmodel.apply({'params': p}, jnp.asarray(x), train=False))

    want = jax_logits(params, images)
    rng = np.random.default_rng(1)
    reruns = [jax_logits(params, (images * (1 + PERTURBATION * rng.standard_normal(
                  images.shape))).astype(np.float32)),
              jax_logits(jax.tree_util.tree_map(lambda a: (a * (1 + PERTURBATION * (
                  rng.standard_normal(a.shape)))).astype(np.float32), params), images)]
    floor = max(float(np.linalg.norm(r - want)) for r in reruns)
    tmodel = texample.ModelHelper().create_model()
    load_jax_numpy(tmodel, params, {})
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (BATCH, 4) and got.dtype == np.float32
    assert float(np.linalg.norm(got - want)) <= _tolerance(want, floor)


@pytest.fixture(scope='module')
def run():
    jexample = _jax_example()
    with JFLAGS.scope(**JFLAGS.as_dict()), TFLAGS.scope(**TFLAGS.as_dict()):
        return _run_small(jexample.ModelHelper, texample.ModelHelper, SMALL, learner='full-prec',
                          exclude_bn=False)
