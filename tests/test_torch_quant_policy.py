"""The QAT policy's grouped routes (learners/uniform_quantization/utils.py):
one grouped fake-quant call per forward quantizes the policy's weights (per
tensor, or in channel or split buckets), each site takes its result, and
each activation goes through fake_quant_select (the select on bits < 32 in
the op).  Held against the per-site routes they replaced (fake_quant,
fake_quant_channel_bucket or fake_quant_split_bucket at each site, then
torch.where(bits < 32, q, kernel); fake_quant on each activation, then
torch.where(bits < 32, q, act)) on a small ResNet on the CPU, with mixed
bits (some 32): the same logits, the same activation sites in the same
order, and the same gradients, bit for bit (the same fp32 formula on the
same inputs).  The JAX package's own per-site policy is held against the
port in tests/test_torch_qat_slice*.py."""

import numpy as np
import pytest
import torch

from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.learners.uniform_quantization import utils as tuq
from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper
from pocketflow_tpu_torch.ops import fake_quant as tfq

torch.set_num_threads(2)
SMALL = dict(ilsvrc_image_size=32, batch_size=2, batch_size_eval=2, nb_smpls_train=8,
             nb_smpls_eval=4, compute_dtype='float32', synthetic_data=True,
             resnet_stem_s2d=True, rand_seed=0)


class PerSitePolicy(tuq.QuantPolicy):
    """The per-site routes: each quantized kernel through fake_quant or a
    bucket op, and each activation through fake_quant, each followed by the
    select on bits < 32."""

    def process_weight(self, path, kernel):
        idx = self.w_index.get(path)
        if idx is None:
            return kernel
        bits = self.w_bits[idx]
        if not TFLAGS.uql_use_buckets:
            q = tfq.fake_quant(kernel, bits)
        elif TFLAGS.uql_bucket_type == 'channel':
            q = tfq.fake_quant_channel_bucket(kernel, bits)
        else:
            q = tfq.fake_quant_split_bucket(kernel, bits, TFLAGS.uql_bucket_size)
        return torch.where(bits < 32, q, kernel)

    def process_act(self, path, act):
        if not path.startswith('act/') or not self.quant_acts:
            return act
        bits = self.a_bits[int(path.split('/')[1])]
        return torch.where(bits < 32, tfq.fake_quant(act, bits).to(act.dtype), act)


class ActRecorder:
    """Wraps a policy's process_act and records the sites it sees, in order."""

    def __init__(self, policy):
        self.sites = []
        inner = policy.process_act

        def process_act(path, act):
            self.sites.append(path)
            return inner(path, act)

        policy.process_act = process_act


def _forward_backward(learner, state, policy, images):
    """Train-mode logits, activation sites and the gradients of a fixed
    function of the logits with respect to every parameter."""
    recorder = ActRecorder(policy)
    for p in state.model.parameters():
        p.grad = None
    logits = learner.model_helper.forward_train(state.model, images, policy=policy)
    weights = torch.linspace(-1.0, 1.0, logits.numel()).reshape(logits.shape)
    (logits * weights).sum().backward()
    grads = {name: p.grad.clone() for name, p in state.model.named_parameters()}
    return logits.detach(), recorder.sites, grads


BUCKETS = {None: {}, 'channel': dict(uql_use_buckets=True, uql_bucket_type='channel'),
           'split': dict(uql_use_buckets=True, uql_bucket_type='split', uql_bucket_size=64)}


@pytest.mark.parametrize('act_bits,buckets', [(32, None), (8, None), (32, 'channel'),
                                              (8, 'channel'), (32, 'split'), (8, 'split')],
                         ids=['32', '8', 'channel-32', 'channel-8', 'split-32', 'split-8'])
def test_grouped_route_equals_per_site_route(act_bits, buckets):
    with TFLAGS.scope(**SMALL, **BUCKETS[buckets], uql_activation_bits=act_bits):
        learner = UniformQuantLearner(None, ModelHelper(resnet_size=18), device='cpu')
        stats = learner.statistics
        state, _, _ = learner.init_state_quant()
        rng = np.random.default_rng(0)
        w_bits = rng.choice([2, 3, 4, 8, 32], size=stats['nb_matmuls']).tolist()
        a_bits = rng.choice([4, 8, 32], size=stats['nb_activations']).tolist()
        state = learner.set_bits(state, w_bits, a_bits)
        images = torch.from_numpy(learner.dataset_train.synthesize_arrays(2)[0][:2])
        images = learner.dataset_train.augment(images, None, False)

        grouped = learner._policy_fn()(state)
        tfq.reset_counters()
        got = _forward_backward(learner, state, grouped, images)
        calls = tfq.counters()['plain']
        per_site = PerSitePolicy(stats['weight_paths'], state.extra['w_bits'],
                                 state.extra['a_bits'], grouped.weights)
        want = _forward_backward(learner, state, per_site, images)

    nb_act_calls = stats['nb_activations'] if act_bits < 32 else 0
    assert calls == 1 + nb_act_calls  # one grouped call for all the weights
    assert torch.equal(got[0], want[0])
    assert got[1] == want[1] and len(got[1]) > stats['nb_activations']
    assert set(got[2]) == set(want[2])
    for name in want[2]:
        assert torch.equal(got[2][name], want[2][name]), name


def test_policy_fn_looks_the_weights_up_once_per_model():
    with TFLAGS.scope(**SMALL):
        learner = UniformQuantLearner(None, ModelHelper(resnet_size=18), device='cpu')
        state, _, _ = learner.init_state_quant()
        policy_fn = learner._policy_fn()
        first, second = policy_fn(state), policy_fn(state)
        assert first.weights is second.weights
        paths = learner.statistics['weight_paths']
        modules = dict(state.model.named_modules())
        assert all(w is modules[p.replace('/', '.')].kernel
                   for w, p in zip(first.weights, paths))
        other, _, _ = learner.init_state_quant()
        assert policy_fn(other).weights[0] is not first.weights[0]


def test_policy_refuses_a_kernel_it_was_not_built_with():
    weight = torch.randn(3, 3, 4, 8)
    policy = tuq.QuantPolicy(['conv'], torch.tensor([4.0]), torch.zeros(0), [weight])
    policy.reset_trace()
    assert policy.process_weight('conv', weight).shape == weight.shape
    with pytest.raises(ValueError, match='not the weight'):
        policy.process_weight('conv', weight.clone())
