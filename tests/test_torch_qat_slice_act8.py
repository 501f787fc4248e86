"""The QAT ResNet-50 slice against the JAX learner, --uql_activation_bits=8:
each of the 49 activations fake-quantized at 8 bits (the port's
fake_quant_select, the select inside the op; the JAX package's
jnp.where(bits < 32, fake_quant(act, bits), act)).  The run and its
tolerances are in tests/torch_slice_parity.py: the quant sites, the eval
logits, each step's loss and metrics, the parameters and BN statistics
after it and the size of its update are held to the slice's bounds (rtol
1e-4, atol 1e-5, plus 2x the JAX reruns' spread).  Beside them,
test_activation_sites_quantize_as_the_reference holds each of the 49 sites
of the port's eval forward to the JAX QuantPolicy.process_act on the same
input, bit for bit.

Two of the slice's checks do not hold at 8 bits, and this file leaves them
out:
* test_eval_logits_match (1e-3 per element): the port's logits differ from
  the JAX package's by up to 1.68 (of max |logit| 100.3), in 7,611 of the
  8,008 elements.  The two frameworks sum the convolutions in other orders,
  so an activation a rounding away from a level's edge lands on another
  8-bit level (a step of 1/255 of the tensor's range), and the flips of one
  site move the inputs of the next: a JAX eval with its images perturbed by
  1e-7 relative moves the logits as far.  The logits are held to that
  spread instead (test_eval_logits_within_the_reference_spread).
* test_two_steps_move_parameters_past_the_tolerance (at least 90% of the
  tensors move past their bound, almost none within the JAX reruns' own
  spread): measured, 109 and 110 of the 267 tensors move past their bound,
  and the median tensor moves 0.81x (step 1) and 1.18x (step 2) of the
  JAX reruns' spread; in step 1 the reruns' updates project at -0.04 and
  0.06 on the reference update (step 2: 0.75 and 0.77).  At 8 bits the
  step is chaotic at this size: the level flips steer the early
  convolutions' gradients (conv_init moves 6.0, the reruns land 9.1 and 9.6
  from the reference).

What the file catches, from broken copies of the port:
* activations left at 32 bits: the site check (act/0 differs in 49% of its
  elements); every other check passes, as the flips move the logits and the
  update farther than the missing quantization does;
* 4-bit activations: the site check, the logits (520.9 against a bound of
  81.3) and the BN statistics;
* no update: the parameters (fc/bias 5.7x its bound) and, in step 2, the
  update's size (0 against 1 +- 0.50);
* a zero gradient through the activations: the parameters
  (stage4_block2/bn3/bn/bias 1.16x its bound).
A learning rate 5% off passes (step 2 projects at 0.81, the reruns at 0.75
and 0.77): the files at 32 bits catch it, and so does
tests/test_torch_qat_act8_exact.py, an 8-bit-activation step in a regime
without level flips.
"""

import pytest

from torch_slice_parity import (  # noqa: F401  (collected here)
    _run, test_activation_sites_quantize_as_the_reference, test_batch_stats_after_two_steps_match,
    test_eval_logits_within_the_reference_spread, test_params_after_two_steps_match,
    test_quant_sites_match, test_train_loss_and_metrics_match,
    test_update_has_the_reference_size)


@pytest.fixture(scope='module')
def run():
    return _run(buckets=False, act_bits=8)
