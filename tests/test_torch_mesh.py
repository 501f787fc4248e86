"""core/mesh.py and utils/devices.py of the port: the --mesh_shape parser
against the JAX package's, the helpers at world size 1, the helpers on two
gloo CPU ranks (tests/torch_dist_ranks.py:mesh_helpers, joined with a 120 s
timeout), a "model" axis refused, and require_dp_only."""

import os

import numpy as np
import pytest
import torch

from pocketflow_tpu.core import mesh as jmesh
from pocketflow_tpu_torch.config import FLAGS as TFLAGS
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.tools import launch

TESTS = os.path.dirname(os.path.abspath(__file__))
SPECS = [('', 8), ('data:8', 8), ('data:4,model:2', 8), ('model:8', 8), ('data:2', 2),
         (' data :2', 2), ('data:1,model:2', 2)]
BAD_SPECS = [('data:3', 8), ('data:4,model:4', 8), ('data:2', 1)]


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


@pytest.mark.parametrize('spec,n', SPECS)
def test_parse_mesh_shape_matches_jax(spec, n):
    assert mesh._parse_mesh_shape(spec, n) == jmesh._parse_mesh_shape(spec, n)


@pytest.mark.parametrize('spec,n', BAD_SPECS)
def test_parse_mesh_shape_refuses_as_jax(spec, n):
    with pytest.raises(ValueError) as port:
        mesh._parse_mesh_shape(spec, n)
    with pytest.raises(ValueError) as ref:
        jmesh._parse_mesh_shape(spec, n)
    assert str(port.value) == str(ref.value)


def test_helpers_at_world_size_one():
    assert (mesh.num_workers(), mesh.worker_rank()) == (1, 0)
    assert mesh.is_primary_worker() and mesh.is_primary_worker('local')
    with pytest.raises(ValueError):
        mesh.is_primary_worker('host')
    mesh.reset_counters()
    tree = {'t': torch.ones(3), 'a': np.arange(4)}
    assert mesh.broadcast_from_primary(tree) is tree
    mesh.auto_barrier()
    grads = [torch.arange(4.0)]
    mesh.all_reduce_mean_(grads)
    lo_hi = torch.tensor([-1.0, 2.0])
    mesh.all_reduce_minmax_(lo_hi)
    assert torch.equal(grads[0], torch.arange(4.0))
    assert torch.equal(lo_hi, torch.tensor([-1.0, 2.0]))
    assert mesh.counters() == {'all_reduce': 0, 'broadcast': 0, 'barrier': 0}
    batch = {'image': np.zeros((6, 2)), 'label': np.arange(6)}
    assert np.array_equal(mesh.shard_batch(batch)['label'], np.arange(6))
    assert mesh.mesh_axes() == {'data': 1}
    assert mesh.distributed_init('cpu') is False


def test_helpers_on_two_ranks(tmp_path):
    ranks = launch.spawn('torch_dist_ranks:mesh_helpers', 2, {'seed': 5},
                         work_dir=str(tmp_path), paths=[TESTS])
    for rank, out in enumerate(ranks):
        assert (out['rank'], out['world']) == (rank, 2)
        assert out['primary'] == out['local_primary'] == (rank == 0)
        # rank 0's tree on both ranks: tensors in place, the rest anew
        assert np.array_equal(out['tree']['t'], ranks[0]['sent']['t'])
        assert np.array_equal(out['tree']['a'], ranks[0]['tree']['a'])
        assert out['tree']['nested0'] == 0.0 and out['tree']['nested_b'] == np.float32(0.5)
        assert out['counts_bcast'] == {'all_reduce': 0, 'broadcast': 4, 'barrier': 0}
        assert out['counts'] == {'all_reduce': 2, 'broadcast': 4, 'barrier': 1}
        # the global min of each min and max of each max
        assert np.array_equal(out['lo_hi'], np.array([[-2.0, 3.0], [0.0, 1.0]], np.float32))
        assert np.array_equal(out['mean'], np.array([0.5, 5.0], np.float32))
    assert not np.array_equal(ranks[1]['sent']['t'], ranks[0]['sent']['t'])
    rng0 = np.random.default_rng(5)
    rng0.standard_normal((3, 4))
    assert np.array_equal(ranks[1]['tree']['a'], rng0.integers(0, 100, 5))


def test_a_model_axis_is_refused():
    from pocketflow_tpu_torch import main as port_main
    with TFLAGS.scope(mesh_shape='data:1,model:2'):
        with pytest.raises(NotImplementedError, match='item 20'):
            mesh.mesh_axes()
    with pytest.raises(NotImplementedError, match='item 20'):
        port_main.main(['--mesh_shape=data:1,model:2', '--synthetic_data'], device='cpu')


def test_require_dp_only_raises_only_under_tensor_parallelism():
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    with TFLAGS.scope(synthetic_data=True, nb_smpls_train=64, nb_smpls_eval=16,
                      enbl_tensor_parallel=True):
        learner = FullPrecLearner(None, ModelHelper(), device='cpu')
    assert learner.enbl_tp is False  # the flag alone: no "model" axis
    learner.require_dp_only('a search')
    learner.enbl_tp = True
    with pytest.raises(NotImplementedError, match='tensor parallelism during a search'):
        learner.require_dp_only('a search')


def test_devices_without_a_card():
    from pocketflow_tpu_torch.utils import devices
    if torch.cuda.is_available():
        pytest.skip('the CPU case: this host has a CUDA device')
    assert devices.list_devices() == [] and devices.pick_devices() == []
    with pytest.raises(RuntimeError, match='requested 1 devices but only 0'):
        devices.pick_devices(1)
    with pytest.raises(RuntimeError, match='wants cuda:0'):
        devices.rank_device()
