"""The QAT ResNet-50 slice against the JAX learner, per-tensor weight quantization (the main path).
The run and its tolerances are in tests/torch_slice_parity.py."""

import pytest

from torch_slice_parity import (  # noqa: F401  (collected here)
    _run, test_batch_stats_after_two_steps_match, test_eval_logits_match,
    test_params_after_two_steps_match, test_quant_sites_match,
    test_train_loss_and_metrics_match, test_two_steps_move_parameters_past_the_tolerance,
    test_update_has_the_reference_size)


@pytest.fixture(scope='module')
def run():
    return _run(buckets=False)
