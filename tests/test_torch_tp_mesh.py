"""Tensor parallelism in core/mesh.py, nn/layers.py and ops/fake_quant.py,
against the JAX package where it has a counterpart:

* the sharding rule (``infer_tp_sharding``) on the JAX test's four leaves
  and on every leaf of ResNet-20 and ResNet-50 (parameters and BN
  statistics), at model sizes 2 and 4, equal to
  ``pocketflow_tpu.core.mesh.infer_tp_sharding`` on a 2-D mesh of its
  virtual devices; ``shard_model_`` shards exactly the kernels it shards;
* the 2-D mesh on four gloo CPU ranks (data:2,model:2): places in JAX's row-
  major order, the model group's gather, sum and max, the data group's sum
  and rows, the broadcasts, the collectives counted by kind;
* a column-parallel PFConv (stride 2, channels-last) and PFDense on two
  ranks against the unsharded layers in float64: outputs, input and kernel
  gradients within 1e-12;
* the plain model-axis fake-quant (a sharded kernel's range the max over
  its shards) on two ranks against the JAX package's per-tensor fake-quant
  of the full kernels, bit for bit;
* the guard matrix at data:1,model:2: JAX's four guarded searches raise
  NotImplementedError naming tensor parallelism.
Every rank is joined with a 120 s timeout.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.core import mesh as jmesh
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.tools import launch

torch.set_num_threads(2)
TESTS = os.path.dirname(os.path.abspath(__file__))
JAX_LEAVES = {'big_dense': (512, 256), 'big_conv': (3, 3, 128, 512), 'tiny_bias': (256,),
              'odd_last': (1024, 129)}


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _jax_specs(tree, model):
    """{path: spec tuple} of the JAX rule on a 2-D mesh of model size `model`."""
    jm = jmesh.build_mesh(jax.devices()[:8], (jmesh.DATA_AXIS, jmesh.MODEL_AXIS),
                          (8 // model, model))
    leaves = jax.tree_util.tree_flatten_with_path(jmesh.infer_tp_sharding(tree, jm))[0]
    return {'/'.join(str(getattr(k, 'key', k)) for k in path): tuple(s.spec)
            for path, s in leaves}


def _port_spec(placement, ndim):
    if placement.axis is None:
        return ()
    return (None,) * (ndim - 1) + (placement.mesh_axis,)


@pytest.mark.parametrize('model', [2, 4])
def test_rule_on_the_jax_tests_leaves(model):
    want = _jax_specs({k: jnp.zeros(v) for k, v in JAX_LEAVES.items()}, model)
    got = mesh.infer_tp_sharding({k: torch.zeros(v) for k, v in JAX_LEAVES.items()}, model)
    assert {k: _port_spec(p, len(JAX_LEAVES[k])) for k, p in got.items()} == want
    assert want['big_dense'] == (None, 'model') and want['odd_last'] == ()
    assert mesh.infer_tp_sharding({'big_dense': torch.zeros(512, 256)}, 1) == {
        'big_dense': mesh.REPLICATED}


def test_batch_and_replicated_placements_and_the_test_mesh():
    jm = jmesh.cpu_test_mesh(8)
    assert _port_spec(mesh.replicated_sharding(), 0) == tuple(jmesh.replicated_sharding(jm).spec)
    assert mesh.data_sharding() == mesh.shard(0, mesh.DATA_AXIS)
    assert tuple(jmesh.data_sharding(jm).spec) == (mesh.DATA_AXIS,)
    assert mesh.cpu_test_mesh(8) == dict(jm.shape)


@pytest.mark.parametrize('size', [20, 50])
@pytest.mark.parametrize('model', [2, 4])
def test_rule_on_every_resnet_leaf(size, model):
    """Every parameter and BN statistic of ResNet-20 @ CIFAR-10 and ResNet-50
    @ ILSVRC-12 (the JAX variables from jax.eval_shape, the port's from its
    module's state dict), by path."""
    from pocketflow_tpu.config import FLAGS as JFLAGS
    if size == 20:
        from pocketflow_tpu.nets.resnet_at_cifar10 import ModelHelper as JHelper
        from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper as THelper
        shape = (2, 32, 32, 3)
    else:
        from pocketflow_tpu.nets.resnet_at_ilsvrc12 import ModelHelper as JHelper
        from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper as THelper
        shape = (2, 64, 64, 3)
    with JFLAGS.scope(resnet_size=size, compute_dtype='float32'):
        jmodel = JHelper().create_model()
        variables = jax.eval_shape(
            lambda x: jmodel.init(jax.random.PRNGKey(0), x, train=False), jnp.zeros(shape))
    want = {}
    for collection in ('params', 'batch_stats'):
        want.update(_jax_specs(variables[collection], model))
    with TFLAGS.scope(resnet_size=size, compute_dtype='float32'):
        tmodel = THelper().create_model()
    port = {name.replace('.', '/'): t for name, t in tmodel.state_dict().items()}
    got = {k: _port_spec(p, port[k].dim())
           for k, p in mesh.infer_tp_sharding(port, model).items()}
    assert got == want
    assert sum(1 for spec in got.values() if spec) >= (0 if size == 20 else 10)


def test_mesh_helpers_on_a_two_by_two_mesh(tmp_path):
    ranks = launch.spawn('torch_dist_ranks:tp_mesh_helpers', 4, {'mesh_shape': 'data:2,model:2'},
                         work_dir=str(tmp_path), paths=[TESTS])
    for rank, out in enumerate(ranks):
        d, m = rank // 2, rank % 2  # JAX's row-major reshape of the devices
        assert out['place'] == (4, 2, 2, d, m)
        partners = [2 * d, 2 * d + 1]  # the model group: one data index
        assert np.array_equal(out['gather_rows'], np.concatenate(
            [np.full((2, 3), float(r), np.float32) for r in partners], axis=-1))
        base = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
        assert np.array_equal(out['gather_act'], np.concatenate(
            [base + 100 * r for r in partners], axis=1)) and out['gather_act_channels_last']
        assert np.array_equal(out['sum_model'], [sum(partners), 2.0])
        assert np.array_equal(out['max_model'], [max(partners), -min(partners)])
        assert np.array_equal(out['sum_data'], [m + (2 + m), 2.0])  # the data group: one model index
        assert out['counts'] == {'all_reduce': 1, 'broadcast': 0, 'barrier': 0,
                                 'all_gather_model': 2, 'all_reduce_sum_model': 1,
                                 'all_reduce_max_model': 1}
        assert out['rows'] == slice(4 * d, 4 * d + 4)
        assert out['dataset_shard'] == (d, 2)  # a data rank's rows, as JAX's data shards
        shard, plain = out['broadcast']
        assert np.array_equal(shard, [float(m)] * 2)  # data rank 0 of its model index
        assert np.array_equal(plain, [0.0, 0.0])      # rank 0's


def test_column_parallel_layers(tmp_path):
    ranks = launch.spawn('tp_layers_rank:run', 2, {'mesh_shape': 'data:1,model:2'},
                         work_dir=str(tmp_path), paths=[TESTS])
    for out in ranks:
        assert out['conv']['kernel_shape'] == (3, 3, 64, 512)
        assert out['dense']['kernel_shape'] == (256, 256)
        for layer in ('conv', 'dense'):
            for key in ('y', 'dx', 'dkernel', 'dbias'):
                assert out[layer][key] <= 1e-12, (layer, key, out[layer][key])


def test_model_axis_fake_quant_matches_jax_on_the_full_kernel(tmp_path):
    """Each rank quantizes its shard of a kernel the rule shards, and two
    replicated weights whole; the results, gathered, equal the JAX package's
    per-tensor fake-quant of the full weights bit for bit."""
    from pocketflow_tpu.ops import fake_quant as jfq
    rng = np.random.default_rng(0)
    weights = [rng.standard_normal((3, 3, 64, 256)).astype(np.float32) * 0.1,
               rng.standard_normal((64, 10)).astype(np.float32),
               rng.standard_normal((1024, 128)).astype(np.float32)]
    # a shard's range falls short of the full kernel's: its extremes are in
    # the other shard's columns
    weights[0][..., 200] = 3.0
    weights[2][:, 3] = -4.0
    bits = [4.0, 8.0, 32.0]
    ranks = launch.spawn('tp_layers_rank:fake_quant', 2,
                         {'mesh_shape': 'data:1,model:2', 'weights': weights, 'bits': bits},
                         work_dir=str(tmp_path), paths=[TESTS])
    for out in ranks:
        assert out['sharded'] == [True, False, True]
        assert out['counts'] == {'all_reduce': 0, 'broadcast': 0, 'barrier': 0,
                                 'all_reduce_max_model': 1}
        for w, b, got in zip(weights, bits, out['out']):
            want = np.asarray(jfq.fake_quant(jnp.asarray(w), jnp.float32(b))) if b < 32 else w
            assert np.array_equal(got, want)
        # the bucket routes: channel buckets need no collective, split buckets
        # gather each sharded kernel (two of three)
        assert out['buckets']['channel']['counts'] == {'all_reduce': 0, 'broadcast': 0,
                                                       'barrier': 0}
        assert out['buckets']['split']['counts']['all_gather_model'] == 2
        for kind, jop in (('channel', lambda w, b: jfq.fake_quant_channel_bucket(w, b)),
                          ('split', lambda w, b: jfq.fake_quant_split_bucket(w, b, 256))):
            for w, b, got in zip(weights, bits, out['buckets'][kind]['out']):
                want = np.asarray(jop(jnp.asarray(w), jnp.float32(b))) if b < 32 else w
                assert np.array_equal(got, want), kind


GUARDED = {'channel': {}, 'chn-pruned-rmt': {}, 'dis-chn-pruned': {},
           'weight-sparse@optimal': {'ws_prune_ratio_prtl': 'optimal'}}


def test_guard_matrix_under_tensor_parallelism(tmp_path):
    """JAX's guarded searches (tests/test_tensor_parallel.py:_TP_GUARDED)
    raise NotImplementedError naming tensor parallelism when they train, the
    port's message naming a flag that exists (--mesh_shape; the JAX message
    names --mesh_model_parallel=1, which no registry defines).  The three
    channel-pruning searches also refuse the rest of their work under tensor
    parallelism (tp_todo, ROADMAP item 30); every learner of JAX's
    _TP_TRAINING list trains (tests/test_torch_tp_step*.py,
    tests/test_torch_tp_learners.py)."""
    from pocketflow_tpu_torch.learners.learner_utils import create_learner  # noqa: F401
    from pocketflow_tpu_torch.learners.channel_pruning.learner import ChannelPrunedLearner
    from pocketflow_tpu_torch.learners.channel_pruning_gpu.learner import (
        ChannelPrunedGpuLearner)
    from pocketflow_tpu_torch.learners.channel_pruning_rmt.learner import (
        ChannelPrunedRmtLearner)
    from pocketflow_tpu_torch.learners.discr_channel_pruning.learner import DisChnPrunedLearner
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
    from pocketflow_tpu_torch.learners.nonuniform_quantization.learner import (
        NonUniformQuantLearner)
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.learners.uniform_quantization_tf.learner import (
        UniformQuantTFLearner)
    from pocketflow_tpu_torch.learners.weight_sparsification.learner import WeightSparseLearner
    for cls in (ChannelPrunedLearner, ChannelPrunedRmtLearner, DisChnPrunedLearner):
        assert 'ROADMAP item 30' in cls.tp_todo
    for cls in (FullPrecLearner, UniformQuantLearner, UniformQuantTFLearner,
                WeightSparseLearner, NonUniformQuantLearner, ChannelPrunedGpuLearner):
        assert cls.tp_todo is None
    flags = dict(synthetic_data=True, batch_size=8, batch_size_eval=8, nb_smpls_train=64,
                 nb_smpls_eval=32, nb_epochs_rat=0.01, compute_dtype='float32',
                 mesh_shape='data:1,model:2', enbl_tensor_parallel=True,
                 save_path=str(tmp_path / 'models' / 'model.ckpt'),
                 log_dir=str(tmp_path / 'logs'))
    ranks = launch.spawn('torch_dist_ranks:tp_guard', 2, {'flags': flags, 'learners': GUARDED},
                         work_dir=str(tmp_path / 'ranks'), paths=[TESTS])
    for out in ranks:
        for name in GUARDED:
            assert out[name] is not None and 'tensor parallelism during' in out[name], name
            assert '--mesh_shape' in out[name] and 'mesh_model_parallel' not in out[name]


def test_dryrun_multichip_on_a_two_by_two_mesh(capsys):
    accuracy = launch.dryrun_multichip(4)
    assert 0.0 <= accuracy <= 1.0
    assert 'mesh=data:2,model:2 tp=True' in capsys.readouterr().out
