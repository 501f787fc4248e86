"""The uniform-tf case of tests/test_torch_tp_step.py: ConvNet @ FMNIST on
data:2,model:2 (four gloo CPU ranks, batch 8 a rank) against the JAX TP step,
per-channel 8-bit weights (a shard's channels are its own columns: no
model-group collective) and 16-bit activations against EMA ranges that clip,
in the quantized regime (step 1 of --uqtf_quant_delay=1); the EMA ranges
after the step compared too.  The same tests as the other cases, on a
worker of its own."""

import pytest

from test_torch_tp_step import (  # noqa: F401  (the tests, collected here too)
    run_case, test_collectives_of_a_tp_step,
    test_replicated_leaves_are_bit_identical_across_model_ranks,
    test_shards_follow_the_jax_rule, test_tp_step_matches_jax_tp_step)

CASES = [('uniform-tf', (2, 2))]


@pytest.fixture(scope='module', params=CASES, ids=['uniform-tf-data2-model2'])
def tp_case(request, tmp_path_factory):
    return run_case(request.param, tmp_path_factory)
