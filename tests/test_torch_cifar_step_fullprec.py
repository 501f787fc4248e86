"""Two full-precision train steps of ResNet-20 @ CIFAR-10 against the JAX
learner's, each from the JAX state (32x32, batch 8, fp32, synthetic CIFAR-10,
the deterministic augment on both sides, learning rate 0.1).  The run and its
tolerances are in tests/torch_slice_parity.py (`_run_small`): each step's loss
and metrics, the parameters and BN statistics after it and the size of its
update, within rtol 1e-4, atol 1e-5 plus 2x the JAX reruns' spread."""

import pytest

from torch_slice_parity import (  # noqa: F401  (collected here)
    CIFAR_RATE, CIFAR_SMALL, _run_small, test_batch_stats_after_two_steps_match,
    test_params_after_two_steps_match, test_train_loss_and_metrics_match,
    test_two_steps_move_parameters_past_the_tolerance, test_update_has_the_reference_size)


@pytest.fixture(scope='module')
def run():
    from pocketflow_tpu.nets.resnet_at_cifar10 import ModelHelper as JHelper
    from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper as THelper
    return _run_small(JHelper, THelper, dict(CIFAR_SMALL, lrn_rate_init=CIFAR_RATE['full-prec']),
                      learner='full-prec')
