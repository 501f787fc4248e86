"""Data parallelism over ``torch.distributed`` (counterpart of
pocketflow_tpu/core/mesh.py): one process per GPU, as torchrun launches them.

The JAX package puts every chip on the "data" axis of one mesh and lets XLA
insert the all-reduces; here each rank holds a replica of the train state and
its rows of the global batch, and the port inserts the collectives itself:

* the gradient mean after the backward (``all_reduce_mean_``, one coalesced
  call over every trained tensor; learners/abstract_learner.py);
* exact sync-BN: the statistics' sums in one call forward, the gradient's in
  one call backward (nn/layers.py);
* the global (min, max) of a per-tensor activation range between K1''s two
  passes (ops/fake_quant.py), and of uniform-tf's EMA ranges;
* eval totals and reported train metrics (``all_reduce_sum_``);
* rank 0's choice of a search, and the initial state (``broadcast_from_primary``).

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used, so that gloo
runs every path with CUDA tensors too (two ranks sharing one card, which NCCL
refuses).  At world size 1 every helper returns at once and no collective is
issued.  ``counters()`` counts the collectives issued, by kind.

``infer_tp_sharding``, ``data_sharding``, ``replicated_sharding`` and
``cpu_test_mesh`` have no counterpart yet: tensor parallelism (a "model" mesh
axis > 1, on DTensor) is the tensor-parallel part of ROADMAP item 20.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pocketflow_tpu_torch.config import FLAGS

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

# collectives issued since the last reset_counters(), by kind
_COUNTS = {'all_reduce': 0, 'broadcast': 0, 'barrier': 0}


def reset_counters():
    for key in _COUNTS:
        _COUNTS[key] = 0


def counters() -> dict:
    return dict(_COUNTS)


def _parse_mesh_shape(spec: str, n_devices: int) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Parse the `mesh_shape` flag ("data:4,model:2") into axis names/sizes
    (the JAX package's parser); the sizes must multiply to `n_devices`."""
    if not spec:
        return (DATA_AXIS,), (n_devices,)
    names, sizes = [], []
    for part in spec.split(','):
        name, _, size = part.partition(':')
        names.append(name.strip())
        sizes.append(int(size))
    total = int(np.prod(sizes))
    if total != n_devices:
        raise ValueError(
            'mesh_shape %r wants %d devices but %d are available' % (spec, total, n_devices))
    return tuple(names), tuple(sizes)


def mesh_axes(world: Optional[int] = None) -> dict:
    """{axis: size} of --mesh_shape over `world` ranks (default: this
    group's): the "data" axis is the world size; a "model" axis > 1 is
    refused until tensor parallelism is ported."""
    world = num_workers() if world is None else world
    spec = FLAGS.get('mesh_shape') or ''
    if any(part.partition(':')[0].strip() == MODEL_AXIS and int(part.partition(':')[2]) > 1
           for part in spec.split(',') if part):
        raise NotImplementedError(
            'mesh_shape %r: a "model" axis > 1 (tensor parallelism) is not ported yet '
            "(ROADMAP 'Modules to port', item 20, its tensor-parallel part)" % spec)
    names, sizes = _parse_mesh_shape(spec, world)
    axes = dict(zip(names, sizes))
    if axes.get(DATA_AXIS, 1) != world:
        raise ValueError('mesh_shape %r: the "data" axis must span the %d ranks'
                         % (FLAGS.get('mesh_shape'), world))
    return axes


def distributed_init(device=None) -> bool:
    """Join the process group torchrun's environment describes (WORLD_SIZE,
    RANK, MASTER_ADDR/MASTER_PORT): NCCL for a CUDA `device`, gloo for the
    CPU.  A group the caller has already initialized is kept, and at world
    size 1 nothing happens.  Returns whether a group is initialized."""
    if dist.is_available() and dist.is_initialized():
        mesh_axes()
        return True
    world = int(os.environ.get('WORLD_SIZE', '1'))
    if world <= 1:
        mesh_axes(1)
        return False
    mesh_axes(world)
    device = torch.device(device if device is not None else
                          ('cuda' if torch.cuda.is_available() else 'cpu'))
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if backend == 'nccl':
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method='env://', world_size=world,
                            rank=int(os.environ['RANK']))
    return True


def num_workers() -> int:
    """The data-parallel degree: the process group's size (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def worker_rank() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_rank() -> int:
    """This process's rank on its host: torchrun's LOCAL_RANK, else its rank."""
    return int(os.environ.get('LOCAL_RANK', worker_rank()))


def is_primary_worker(scope: str = 'global') -> bool:
    """Whether this process is the primary one, of all ('global') or of its
    host ('local')."""
    if scope == 'global':
        return worker_rank() == 0
    if scope == 'local':
        return local_rank() == 0
    raise ValueError('unrecognized worker scope: ' + scope)


def auto_barrier():
    """A barrier across the group; nothing at world size 1."""
    if num_workers() > 1:
        _COUNTS['barrier'] += 1
        dist.barrier()


def comm_device() -> torch.device:
    """Where a host value is staged for a collective: NCCL's device, or the CPU."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def _broadcast_leaf(leaf):
    if isinstance(leaf, torch.Tensor):
        data = leaf.data
        if data.is_contiguous():
            _COUNTS['broadcast'] += 1
            dist.broadcast(data, src=0)
        else:
            buf = data.contiguous()
            _COUNTS['broadcast'] += 1
            dist.broadcast(buf, src=0)
            data.copy_(buf)
        return leaf
    if isinstance(leaf, (np.ndarray, np.generic, float, int, bool)):
        array = np.asarray(leaf)
        sent = array.astype(np.uint8) if array.dtype == np.bool_ else array
        buf = torch.from_numpy(np.ascontiguousarray(sent)).to(comm_device())
        _COUNTS['broadcast'] += 1
        dist.broadcast(buf, src=0)
        out = buf.cpu().numpy().astype(array.dtype, copy=False)
        return out if isinstance(leaf, np.ndarray) else type(leaf)(out.item())
    if leaf is None or isinstance(leaf, str):
        return leaf
    raise TypeError('broadcast_from_primary: cannot broadcast a %s' % type(leaf).__name__)


def broadcast_from_primary(tree):
    """Rank 0's values of a tree of tensors, numpy arrays and numbers (dicts,
    lists and tuples of them) on every rank: tensors in place, the rest
    returned anew.  The identity at world size 1."""
    if num_workers() == 1:
        return tree
    if isinstance(tree, dict):
        return type(tree)((k, broadcast_from_primary(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(broadcast_from_primary(v) for v in tree)
    return _broadcast_leaf(tree)


def broadcast_module_(module: torch.nn.Module):
    """Rank 0's parameters and buffers into `module`, in place."""
    broadcast_from_primary([t for t in module.state_dict(keep_vars=True).values()])


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of `tensor` over the ranks, in place (contiguous)."""
    if num_workers() > 1:
        _COUNTS['all_reduce'] += 1
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor


def all_reduce_mean_(tensors: Sequence[torch.Tensor]):
    """Each tensor replaced by its mean over the ranks, in place: one
    all_reduce of all of them packed together (one a dtype)."""
    world = num_workers()
    if world == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        _COUNTS['all_reduce'] += 1
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(world)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_grads_(params):
    """The mean over the ranks of the gradient of each parameter that has
    one (what the global batch's mean loss gives), in place."""
    all_reduce_mean_([p.grad for p in params if p.grad is not None])


def all_reduce_max_(tensor: torch.Tensor) -> torch.Tensor:
    """The elementwise max of `tensor` over the ranks, in place (contiguous)."""
    if num_workers() > 1:
        _COUNTS['all_reduce'] += 1
        dist.all_reduce(tensor, op=dist.ReduceOp.MAX)
    return tensor


def all_reduce_minmax_(lo_hi: torch.Tensor) -> torch.Tensor:
    """`lo_hi` [..., 2] of (min, max) pairs replaced by the global min and
    max of each, in place: one MAX all_reduce of (-min, max)."""
    if num_workers() > 1:
        buf = all_reduce_max_(torch.stack([-lo_hi[..., 0], lo_hi[..., 1]], dim=-1))
        lo_hi[..., 0] = -buf[..., 0]
        lo_hi[..., 1] = buf[..., 1]
    return lo_hi


def all_gather_rows(array: np.ndarray) -> np.ndarray:
    """[world, *shape] of every rank's float64 `array` (one shape on every
    rank), in rank order: one SUM all_reduce of a zero buffer in which each
    rank fills its own slot, exact since every other term is 0.  At world
    size 1, `array[None]`."""
    array = np.asarray(array, np.float64)
    world = num_workers()
    if world == 1:
        return array[None].copy()
    buf = torch.zeros((world,) + array.shape, dtype=torch.float64, device=comm_device())
    buf[worker_rank()] = torch.from_numpy(array)
    return all_reduce_sum_(buf).cpu().numpy()


def shard_rows(n: int) -> slice:
    """This rank's rows of a global batch of `n` (n // world each, in rank order)."""
    world = num_workers()
    if n % world:
        raise ValueError('a global batch of %d does not split over %d ranks' % (n, world))
    local = n // world
    return slice(worker_rank() * local, (worker_rank() + 1) * local)


def shard_batch(batch: Any):
    """This rank's rows of a global batch: a dict of arrays or tensors, or one."""
    if isinstance(batch, dict):
        return {k: shard_batch(v) for k, v in batch.items()}
    return batch[shard_rows(batch.shape[0])]
