"""Two full-precision train steps of ResNet-20 @ CIFAR-10 with --enbl_dst
against the JAX learner's, each from the JAX state: both distill from one
teacher (the bridged initial parameters, each scaled by 1 + 0.05 N(0, 1)),
its logits on the step's augmented images, loss_w_dst 4 and tempr_dst 4.
Sizes, run and tolerances as tests/test_torch_cifar_step_fullprec.py; the
KD loss is among the checked metrics (`dst_loss`)."""

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
                      learner='full-prec', enbl_dst=True)


def test_the_step_reports_the_distillation_loss(run):
    for step in run['steps']:
        assert step['port'][0]['dst_loss'] > 0 and 'dst_loss' in step['jax'][0]
