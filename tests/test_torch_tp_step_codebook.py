"""The non-uniform case of tests/test_torch_tp_step.py: ConvNet @ FMNIST on
data:1,model:2 (two gloo CPU ranks, batch 16 each), 4-bit k-means codebooks
trained with the weights (--nuql_opt_mode=both), fc3's codebook on its
sharded kernel (the full kernel gathered for the assignment, the codebook's
gradient summed over the model group).  The JAX package's non-uniform
learner does not run under tensor parallelism (REFERENCE_DP), so its
data-parallel step at the same global batch is the reference, with the
same bound; the codebooks after the step are compared too.  The same tests
as the other cases, on a worker of its own."""

import pytest

from test_torch_tp_step import (  # noqa: F401  (the tests, collected here too)
    run_case, test_collectives_of_a_tp_step,
    test_replicated_leaves_are_bit_identical_across_model_ranks,
    test_shards_follow_the_jax_rule, test_tp_step_matches_jax_tp_step)

CASES = [('non-uniform', (1, 2))]


@pytest.fixture(scope='module', params=CASES, ids=['non-uniform-data1-model2'])
def tp_case(request, tmp_path_factory):
    return run_case(request.param, tmp_path_factory)
