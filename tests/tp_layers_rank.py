"""Rank targets of tests/test_torch_tp_mesh.py that set --mesh_shape first
(tests/torch_dist_ranks.py holds the rest)."""

from pocketflow_tpu_torch.config import FLAGS


def run(mesh_shape):
    import torch_dist_ranks
    from pocketflow_tpu_torch.core import mesh
    with FLAGS.scope(mesh_shape=mesh_shape):
        mesh.setup_groups()
        return torch_dist_ranks.tp_layers(0)


def fake_quant(mesh_shape, weights, bits):
    import torch_dist_ranks
    from pocketflow_tpu_torch.core import mesh
    with FLAGS.scope(mesh_shape=mesh_shape):
        mesh.setup_groups()
        return torch_dist_ranks.tp_fake_quant(weights, bits)
