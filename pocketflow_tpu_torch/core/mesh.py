"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
pocketflow_tpu/core/mesh.py): one process per GPU, as torchrun launches them.

``--mesh_shape=data:D,model:M`` lays the D x M ranks out as the JAX
package lays its devices out (``np.asarray(devices).reshape(sizes)``, row
major): rank r sits at (r // M, r % M).  Each rank belongs to one data group
(the D ranks of its model index) and one model group (the M ranks of its
data index); every rank builds every group, in one order
(``setup_groups``).  Without a "model" axis the data group is the world
and no group is built.

The JAX package lets XLA insert the collectives; here the port inserts them:

* over the data group, on the rows of the global batch: the gradient mean
  after the backward (``all_reduce_grads_``), exact sync-BN (nn/layers.py),
  the global (min, max) of a per-tensor activation range between K1''s two
  passes (ops/fake_quant.py) and of uniform-tf's EMA ranges, eval totals and
  reported train metrics (``all_reduce_sum_``, ``all_reduce_mean_``);
* over the model group, under tensor parallelism (``infer_tp_sharding``: a
  large kernel's last axis split over the model axis, held as a
  ``ModelShard``): a column-parallel layer's output gathered along its
  channels (``all_gather_model``), its input's gradient summed
  (``all_reduce_sum_model_``), and a sharded kernel's per-tensor range
  (``all_reduce_max_model_``);
* over the world: rank 0's choice of a search and the initial state
  (``broadcast_from_primary``), barriers.

Model ranks of one data group hold the same rows, so a data-axis reduction
over the world would count them M times.  Every collective here runs on
NCCL and on gloo (two ranks sharing one card, which NCCL refuses), with CUDA
tensors too.  At world size 1 every helper returns at once and no
collective is issued.  ``counters()`` counts the collectives issued, by kind
(the model group's kinds once one was issued).
"""

from __future__ import annotations

import os
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pocketflow_tpu_torch.config import FLAGS

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

# collectives issued since the last reset_counters(), by kind; the model
# group's kinds show in counters() once one was issued
_COUNTS = {'all_reduce': 0, 'broadcast': 0, 'barrier': 0}
_MODEL_COUNTS = {'all_gather_model': 0, 'all_reduce_sum_model': 0, 'all_reduce_max_model': 0}


def reset_counters():
    for counts in (_COUNTS, _MODEL_COUNTS):
        for key in counts:
            counts[key] = 0


def counters() -> dict:
    return {**_COUNTS, **{k: v for k, v in _MODEL_COUNTS.items() if v}}


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


def world_size() -> int:
    """The process group's size (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def mesh_axes(world: Optional[int] = None) -> dict:
    """{axis: size} of --mesh_shape over `world` ranks (default: the process
    group's), as the JAX package's mesh.shape: the sizes multiply to the
    world (the parser refuses any other), and only "data" and "model" axes
    are known."""
    world = world_size() if world is None else world
    spec = FLAGS.get('mesh_shape') or ''
    names, sizes = _parse_mesh_shape(spec, world)
    unknown = sorted(set(names) - {DATA_AXIS, MODEL_AXIS})
    if unknown:
        raise ValueError('mesh_shape %r: unknown axes %s (the port knows "%s" and "%s")'
                         % (spec, unknown, DATA_AXIS, MODEL_AXIS))
    return dict(zip(names, sizes))


class _Layout(NamedTuple):
    key: tuple
    data_size: int
    model_size: int
    data_group: Any    # None: the world
    model_group: Any   # None: no model axis


_LAYOUT: Optional[_Layout] = None


def _layout_key() -> tuple:
    """The process group (the object: a group made after another was
    destroyed is a new key), the world size and --mesh_shape."""
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    return (group, world_size(), FLAGS.get('mesh_shape') or '')


def _axes_sizes() -> Tuple[int, int]:
    """(D, M) of --mesh_shape over this process group (no group needed)."""
    if _LAYOUT is not None and _LAYOUT.key == _layout_key():
        return _LAYOUT.data_size, _LAYOUT.model_size
    axes = mesh_axes()
    return axes.get(DATA_AXIS, 1), axes.get(MODEL_AXIS, 1)


def setup_groups():
    """Build this process group's data and model groups for --mesh_shape
    (once for a group and a mesh shape; the groups of an earlier mesh shape
    on the same process group are destroyed): every rank calls it at the
    same point, as ``dist.new_group`` requires (``distributed_init`` and
    the learners' ``__init__`` do).  Without a "model" axis > 1 no group is
    built."""
    global _LAYOUT
    key = _layout_key()
    if _LAYOUT is not None and _LAYOUT.key == key:
        return
    if _LAYOUT is not None and _LAYOUT.key[0] is not None and _LAYOUT.key[0] is key[0]:
        for group in {_LAYOUT.data_group, _LAYOUT.model_group} - {None}:
            dist.destroy_process_group(group)
    data, model = _axes_sizes()
    data_group = model_group = None
    if model > 1:
        rank = worker_rank()
        for m in range(model):  # the data groups, then the model groups
            group = dist.new_group([d * model + m for d in range(data)])
            if m == rank % model:
                data_group = group
        for d in range(data):
            group = dist.new_group([d * model + m for m in range(model)])
            if d == rank // model:
                model_group = group
    _LAYOUT = _Layout(key, data, model, data_group, model_group)


def _layout() -> _Layout:
    """The mesh's groups.  A mesh without a "model" axis > 1 needs none; one
    with a model axis must have had them built (``setup_groups``) for this
    process group and --mesh_shape: a getter never issues the collective
    ``dist.new_group``, which a read on some ranks only would hang on."""
    key = _layout_key()
    if _LAYOUT is not None and _LAYOUT.key == key:
        return _LAYOUT
    data, model = _axes_sizes()
    if model > 1:
        raise RuntimeError('mesh_shape %r has a "model" axis: call mesh.setup_groups() on every '
                           'rank first' % (key[2],))
    return _Layout(key, data, model, None, None)


def data_size() -> int:
    """The data-parallel degree D: the "data" axis."""
    return _axes_sizes()[0]


def model_size() -> int:
    """The tensor-parallel degree M: the "model" axis."""
    return _axes_sizes()[1]


def data_rank() -> int:
    """This rank's index on the "data" axis: r // M."""
    return worker_rank() // model_size()


def model_rank() -> int:
    """This rank's index on the "model" axis: r % M."""
    return worker_rank() % model_size()


def data_group():
    """The group of this rank's data axis (None: the world)."""
    return _layout().data_group


def model_group():
    """The group of this rank's model axis (None without a model axis)."""
    return _layout().model_group


def distributed_init(device=None) -> bool:
    """Join the process group torchrun's environment describes (WORLD_SIZE,
    RANK, MASTER_ADDR/MASTER_PORT): NCCL for a CUDA `device`, gloo for the
    CPU; then build the mesh's groups (``setup_groups``).  A group the
    caller has already initialized is kept, and at world size 1 nothing
    happens.  Returns whether a group is initialized."""
    if dist.is_available() and dist.is_initialized():
        setup_groups()
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
    setup_groups()
    return True


def num_workers() -> int:
    """The data-parallel degree (the JAX package's): the "data" axis, the
    world size without a "model" axis (1 without a group)."""
    return data_size()


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
    """A barrier across the world; nothing at world size 1."""
    if world_size() > 1:
        _COUNTS['barrier'] += 1
        dist.barrier()


def comm_device() -> torch.device:
    """Where a host value is staged for a collective: NCCL's device, or the CPU."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def _broadcast_tensor(data: torch.Tensor, src: int = 0, group=None):
    buf = data if data.is_contiguous() else data.contiguous()
    _COUNTS['broadcast'] += 1
    dist.broadcast(buf, src=src, group=group)
    if buf is not data:
        data.copy_(buf)


def _broadcast_leaf(leaf):
    if isinstance(leaf, ModelShard):  # the shards of one model index
        if data_size() > 1:
            _broadcast_tensor(leaf.data, src=model_rank(), group=data_group())
        return leaf
    if isinstance(leaf, torch.Tensor):
        _broadcast_tensor(leaf.data)
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
    returned anew; a ``ModelShard`` takes the value of data rank 0 of its
    model index.  The identity at world size 1."""
    if world_size() == 1:
        return tree
    if isinstance(tree, dict):
        return type(tree)((k, broadcast_from_primary(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(broadcast_from_primary(v) for v in tree)
    return _broadcast_leaf(tree)


def broadcast_like_(tensor: torch.Tensor, param: torch.Tensor):
    """A buffer of `param` (its SGD momentum) in place from rank 0, or, where
    `param` is a ModelShard, from data rank 0 of its model index."""
    if world_size() == 1:
        return
    if isinstance(param, ModelShard):
        if data_size() > 1:
            _broadcast_tensor(tensor, src=model_rank(), group=data_group())
    else:
        _broadcast_tensor(tensor)


def broadcast_module_(module: torch.nn.Module):
    """Rank 0's parameters and buffers into `module`, in place (each
    ``ModelShard`` its model index's)."""
    broadcast_from_primary([t for t in module.state_dict(keep_vars=True).values()])


def all_reduce_sum_(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of `tensor` over the data group, in place (contiguous)."""
    if num_workers() > 1:
        _COUNTS['all_reduce'] += 1
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=data_group())
    return tensor


def _all_reduce_mean_(tensors: Sequence[torch.Tensor], group, size: int):
    if size == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for packed in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in packed])
        _COUNTS['all_reduce'] += 1
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(size)
        offset = 0
        for t in packed:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_mean_(tensors: Sequence[torch.Tensor]):
    """Each tensor replaced by its mean over the data group, in place: one
    all_reduce of all of them packed together (one a dtype)."""
    _all_reduce_mean_(list(tensors), data_group(), num_workers())


def all_reduce_grads_(params):
    """The mean over the data ranks of the gradient of each parameter that
    has one (what the global batch's mean loss gives), in place.  Under a
    "model" axis a ``ModelShard``'s gradient is its columns' and takes the
    mean over its data group; every other gradient is equal on the model
    ranks of a data group and takes the mean over the world (the same value,
    and the same bits on every rank, so that replicated parameters stay
    bit-identical across the model ranks)."""
    grads = [p for p in params if p.grad is not None]
    if model_size() == 1:
        all_reduce_mean_([p.grad for p in grads])
        return
    _all_reduce_mean_([p.grad for p in grads if isinstance(p, ModelShard)], data_group(),
                      num_workers())
    _all_reduce_mean_([p.grad for p in grads if not isinstance(p, ModelShard)], None,
                      world_size())


def all_reduce_max_(tensor: torch.Tensor) -> torch.Tensor:
    """The elementwise max of `tensor` over the data group, in place (contiguous)."""
    if num_workers() > 1:
        _COUNTS['all_reduce'] += 1
        dist.all_reduce(tensor, op=dist.ReduceOp.MAX, group=data_group())
    return tensor


def all_reduce_minmax_(lo_hi: torch.Tensor) -> torch.Tensor:
    """`lo_hi` [..., 2] of (min, max) pairs replaced by the min and max of
    each over the data group, in place: one MAX all_reduce of (-min, max)."""
    if num_workers() > 1:
        buf = all_reduce_max_(torch.stack([-lo_hi[..., 0], lo_hi[..., 1]], dim=-1))
        lo_hi[..., 0] = -buf[..., 0]
        lo_hi[..., 1] = buf[..., 1]
    return lo_hi


def all_gather_rows(array: np.ndarray) -> np.ndarray:
    """[D, *shape] of every data rank's float64 `array` (one shape on every
    rank), in data-rank order: one SUM all_reduce over the data group of a
    zero buffer in which each rank fills its own slot, exact since every
    other term is 0.  At data size 1, `array[None]`."""
    array = np.asarray(array, np.float64)
    world = num_workers()
    if world == 1:
        return array[None].copy()
    buf = torch.zeros((world,) + array.shape, dtype=torch.float64, device=comm_device())
    buf[data_rank()] = torch.from_numpy(array)
    return all_reduce_sum_(buf).cpu().numpy()


def shard_rows(n: int) -> slice:
    """This rank's rows of a global batch of `n` (n // D each, in data-rank
    order; the model ranks of a data group take the same rows)."""
    world = num_workers()
    if n % world:
        raise ValueError('a global batch of %d does not split over %d ranks' % (n, world))
    local = n // world
    return slice(data_rank() * local, (data_rank() + 1) * local)


def shard_batch(batch: Any):
    """This rank's rows of a global batch: a dict of arrays or tensors, or one."""
    if isinstance(batch, dict):
        return {k: shard_batch(v) for k, v in batch.items()}
    return batch[shard_rows(batch.shape[0])]


# ---------------------------------------------------------------------------
# the model axis
# ---------------------------------------------------------------------------

def all_gather_model(tensor: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model group's `tensor`s (one shape on every rank) joined along
    `dim` in model-rank order, a new tensor (channels-last where `tensor`
    is); `tensor` itself without a model axis.  One
    ``all_gather_into_tensor`` (NCCL and gloo alike)."""
    size = model_size()
    if size == 1:
        return tensor
    dim = dim % tensor.dim()
    channels_last = (tensor.dim() == 4 and not tensor.is_contiguous()
                     and tensor.is_contiguous(memory_format=torch.channels_last))
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    src = tensor.contiguous()
    # gloo wants the parts stacked along the first axis: [size * n0, ...]
    parts = torch.empty((size * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                        device=src.device)
    _MODEL_COUNTS['all_gather_model'] += 1
    dist.all_gather_into_tensor(parts, src, group=model_group())
    return torch.cat(parts.chunk(size), dim=dim).contiguous(memory_format=fmt)


def _dense_buffer(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` whose memory is one dense block in its own layout
    (channels-last stays channels-last), for an in-place collective."""
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last) \
            and not t.is_contiguous():
        return t.clone(memory_format=torch.channels_last)
    return t.contiguous().clone() if t.is_contiguous() else t.contiguous()


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        buf = _dense_buffer(g)
        if buf.dim() == 4 and not buf.is_contiguous():  # channels-last: reduce its NHWC view
            all_reduce_sum_model_(buf.permute(0, 2, 3, 1))
        else:
            all_reduce_sum_model_(buf)
        return buf


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dim):
        ctx.dim = dim % y.dim()
        ctx.width = y.shape[ctx.dim]
        return all_gather_model(y, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, model_rank() * ctx.width, ctx.width), None


def to_model(x: torch.Tensor) -> torch.Tensor:
    """`x` as an input every model rank uses for its own columns: the
    identity forward; the backward sums the gradient over the model group
    (each rank's holds its columns' part)."""
    return _ToModel.apply(x)


def gather_model(y: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``all_gather_model(y, dim)``, differentiable: the backward takes this
    rank's slice of the gradient."""
    return _GatherModel.apply(y, dim)


def all_reduce_sum_model_(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of `tensor` over the model group, in place (contiguous)."""
    if model_size() > 1:
        _MODEL_COUNTS['all_reduce_sum_model'] += 1
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=model_group())
    return tensor


def all_reduce_max_model_(tensor: torch.Tensor) -> torch.Tensor:
    """The elementwise max of `tensor` over the model group, in place (contiguous)."""
    if model_size() > 1:
        _MODEL_COUNTS['all_reduce_max_model'] += 1
        dist.all_reduce(tensor, op=dist.ReduceOp.MAX, group=model_group())
    return tensor


# ---------------------------------------------------------------------------
# sharding rules (tensor parallelism)
# ---------------------------------------------------------------------------

# leaves smaller than this stay replicated even under tensor parallelism
# (the JAX package's _TP_MIN_SIZE)
_TP_MIN_SIZE = 1 << 16


class Placement(NamedTuple):
    """Where a leaf lives on the mesh: split along `axis` over `mesh_axis`,
    or replicated (axis None)."""
    axis: Optional[int]
    mesh_axis: Optional[str]


REPLICATED = Placement(None, None)


def shard(axis: int = -1, mesh_axis: str = MODEL_AXIS) -> Placement:
    return Placement(axis, mesh_axis)


class ModelShard(torch.nn.Parameter):
    """A parameter holding this rank's slice of its full tensor's last axis
    (``shard(-1, 'model')``): the model ranks' slices in model-rank order
    make the full tensor.  Copies (``copy.deepcopy``) stay shards."""


def _tp_placement(shape, model: int) -> Placement:
    if (model > 1 and shape and len(shape) >= 1 and int(np.prod(shape)) >= _TP_MIN_SIZE
            and shape[-1] % model == 0):
        return shard(-1, MODEL_AXIS)
    return REPLICATED


def infer_tp_sharding(tree, model: Optional[int] = None):
    """The tensor-parallel placement of each leaf of `tree` (dicts, lists and
    tuples of tensors, arrays or anything with a shape), by the JAX
    package's rule: a leaf of at least 65,536 elements whose last axis
    divides by the model size (default: this mesh's) is split along that
    axis over the "model" axis, ``shard(-1, 'model')``; every other leaf,
    and every leaf at model size 1, is ``REPLICATED``.  The port's kernels
    are HWIO and [in, out], so the split axis is the output axis."""
    model = model_size() if model is None else model
    if isinstance(tree, dict):
        return type(tree)((k, infer_tp_sharding(v, model)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(infer_tp_sharding(v, model) for v in tree)
    shape = getattr(tree, 'shape', None)
    return _tp_placement(tuple(shape) if shape is not None else None, model)


def data_sharding() -> Placement:
    """A batch's placement: its leading axis split over the "data" axis."""
    return shard(0, DATA_AXIS)


def replicated_sharding() -> Placement:
    return REPLICATED


def cpu_test_mesh(n: int = 8) -> dict:
    """The axes of the tests' mesh of `n` gloo CPU ranks (all on "data"),
    which tools/launch.spawn starts."""
    return {DATA_AXIS: n}


def shard_tensor(full: torch.Tensor, placement: Placement) -> torch.Tensor:
    """This rank's slice of `full` under `placement` (a contiguous copy), or
    `full` itself where it is replicated."""
    if placement.axis is None:
        return full
    if placement.mesh_axis != MODEL_AXIS:
        raise ValueError('shard_tensor: %r is not a model-axis placement' % (placement,))
    width = full.shape[placement.axis] // model_size()
    return full.narrow(placement.axis, model_rank() * width, width).contiguous()


def gather_tensor(local: torch.Tensor, placement: Placement) -> torch.Tensor:
    """The full tensor of this rank's slice `local` (``all_gather_model``),
    or `local` itself where it is replicated."""
    if placement.axis is None:
        return local
    return all_gather_model(local.detach().contiguous(), placement.axis)
