"""The port's own checkpoints: ``torch.save`` of a train state under
``<save_path>-<step>.pt``, with a JSON index naming the newest one; and the
JAX package's, read.

A minimal counterpart of pocketflow_tpu/core/checkpoint.py.  The port's
files hold tensors and plain containers only and are loaded with
``weights_only=True``.  ``restore_intersecting`` grafts the parameters of a
checkpoint into a model by name and shape (a detector's backbone from a
classification checkpoint).

Where a directory has no ``checkpoint.json``, ``restore_latest`` reads the
JAX package's msgpack checkpoint named by its ``checkpoint`` index
(``<save_path>-<step>.msgpack``, ``flax.serialization.to_bytes`` of a
``TrainState``: step, params, batch_stats, opt_state, extra) and maps it into
the port's payload: the model through ``core/bridge.from_jax_numpy``, extra
through ``extra_from_jax``, the SGD momentum from optax's trace by parameter
name (``load_optimizer`` places it).  The decoder is self-contained: the
msgpack subset flax writes (maps, arrays, str, bin, ints, floats, nil,
bool, ext and fixext), flax's ext codes (1 ndarray, 2 complex, 3 numpy
scalar), chunked leaves, and bfloat16 leaves as ``torch.bfloat16`` tensors
(numpy has no bfloat16).  The JAX package's orbax directories are not read.

``save_state`` writes a train state whatever the mesh, so that it resumes
on any other (``restore_latest`` returns the full state; the learner takes
each rank's shard of it).  --ckpt_backend (the JAX package's flag):

* 'msgpack' (the default; the name is the JAX package's, the file the
  port's ``.pt``): the state gathered over the model group, rank 0 writes
  it synchronously;
* 'orbax': ``torch.distributed.checkpoint.async_save`` into
  ``<save_path>-<step>.dcp/``, each rank writing only its own shards (a
  ``ModelShard`` and its momentum under '<name>/shard<m>of<M>', the
  replicated tensors once) from a host copy taken at the save, on a gloo
  group of its own, while training goes on; rank 0 writes ``meta.pt`` (step, optimizer settings, extra, which
  entries are shards) beside them, and the index names the directory once
  the save is complete (``wait_for_async_saves``, which the next save and
  every restore call first).  Any mesh loads it: each rank reads every
  shard and joins them.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh

FLAGS.DEFINE_string('ckpt_backend', 'msgpack',
                    "checkpoint backend: 'msgpack' (sync, single file) | "
                    "'orbax' (async, sharded-array aware)")

INDEX = 'checkpoint.json'
JAX_INDEX = 'checkpoint'  # pocketflow_tpu/core/checkpoint.py's index file
DCP_META = 'meta.pt'      # beside an 'orbax' checkpoint's shards


def _index_path(save_dir: str) -> str:
    return os.path.join(save_dir, INDEX)


def _write_index(save_dir: str, path: str, step: int):
    tmp_index = _index_path(save_dir) + '.tmp'
    with open(tmp_index, 'w') as fout:
        json.dump({'latest': os.path.basename(path), 'step': step}, fout)
    os.replace(tmp_index, _index_path(save_dir))


def save(save_path: str, payload: Dict[str, Any], step: int) -> str:
    """Write `payload` to ``<save_path>-<step>.pt`` (atomically) and index it;
    under data parallelism only rank 0 writes, and every rank returns the
    path (the caller's barrier makes the file visible to all)."""
    path = '%s-%d.pt' % (save_path, step)
    if not mesh.is_primary_worker():
        return path
    save_dir = os.path.dirname(save_path) or '.'
    os.makedirs(save_dir, exist_ok=True)
    torch.save(payload, path + '.tmp')
    os.replace(path + '.tmp', path)
    _write_index(save_dir, path, step)
    return path


def _flat_params(optimizer: torch.optim.Optimizer):
    return [p for group in optimizer.param_groups for p in group['params']]


def _is_shard_buffer(param, value) -> bool:
    return isinstance(param, mesh.ModelShard) and torch.is_tensor(value) \
        and tuple(value.shape) == tuple(param.shape)


def full_optimizer_state(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """`optimizer.state_dict()` with each buffer of a ModelShard (its SGD
    momentum) gathered into its full tensor (every model rank calls it)."""
    state = optimizer.state_dict()
    flat = _flat_params(optimizer)
    out = {}
    for index, buffers in state['state'].items():
        out[index] = {key: mesh.gather_tensor(value, mesh.shard(-1))
                      if _is_shard_buffer(flat[index], value) else value
                      for key, value in buffers.items()}
    return {'state': out, 'param_groups': state['param_groups']}


def _map_shard_leaves(model: torch.nn.Module, extra: Any, fn, full: bool) -> Any:
    """`extra` with fn(leaf) for each tensor filed under the name of one of
    `model`'s ModelShard parameters (a weight-sparsification mask or backup)
    whose shape is the shard's (`full` False) or the full kernel's (True);
    dicts are walked in order, so every model rank maps the same leaves."""
    from pocketflow_tpu_torch.nn import layers
    shards = {name: p for name, p in model.named_parameters()
              if isinstance(p, mesh.ModelShard)}
    if not shards or extra is None:
        return extra

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = type(node)()
        for key, value in node.items():
            param = shards.get(key)
            want = None if param is None else (
                layers.full_shape(key, param) if full else tuple(param.shape))
            if torch.is_tensor(value) and want is not None and tuple(value.shape) == want:
                out[key] = fn(value)
            else:
                out[key] = walk(value)
        return out
    return walk(extra)


def full_extra(model: torch.nn.Module, extra: Any) -> Any:
    """`extra` with the shard-shaped tensors filed under ModelShard
    parameters' names gathered into full tensors (every model rank calls it)."""
    return _map_shard_leaves(model, extra, lambda t: mesh.gather_tensor(t, mesh.shard(-1)),
                             full=False)


def local_extra(model: torch.nn.Module, extra: Any) -> Any:
    """The inverse of full_extra: each full tensor filed under a ModelShard
    parameter's name cut to this rank's shard."""
    return _map_shard_leaves(model, extra, lambda t: mesh.shard_tensor(t, mesh.shard(-1)),
                             full=True)


def save_state(save_path: str, step: int, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer, extra: Any) -> str:
    """Save a train state by --ckpt_backend (every rank calls it): 'msgpack'
    gathers the full state and rank 0 writes ``<save_path>-<step>.pt``;
    'orbax' starts an asynchronous sharded save into
    ``<save_path>-<step>.dcp``.  Returns the path."""
    from pocketflow_tpu_torch.nn import layers
    backend = FLAGS.get('ckpt_backend') or 'msgpack'
    if backend not in ('msgpack', 'orbax'):
        raise ValueError("unknown ckpt_backend %r: 'msgpack' or 'orbax'" % backend)
    extra = full_extra(model, extra)
    if backend == 'orbax':
        return _dcp_save(save_path, step, model, optimizer, extra)
    return save(save_path, {'step': step, 'model': layers.full_state_dict(model),
                            'optimizer': full_optimizer_state(optimizer), 'extra': extra}, step)


# ---------------------------------------------------------------------------
# --ckpt_backend=orbax: torch.distributed.checkpoint, asynchronous, sharded
# ---------------------------------------------------------------------------

_PENDING = []  # (future, save_dir, path, step) of the saves in flight
_DCP_GROUP = []  # [(the process group, the gloo group the saves run on)]


def _dcp_group():
    """A gloo group over the world for the saves' own collectives (they run
    on a thread beside the train step's), built at the first save, which
    every rank makes at the same point; None at world size 1."""
    if mesh.world_size() == 1:
        return None
    import torch.distributed as dist
    if not _DCP_GROUP or _DCP_GROUP[0][0] is not dist.group.WORLD:
        _DCP_GROUP[:] = [(dist.group.WORLD, dist.new_group(backend='gloo'))]
    return _DCP_GROUP[0][1]


def _shard_key(name: str) -> str:
    return '%s/shard%dof%d' % (name, mesh.model_rank(), mesh.model_size())


def _host_copy(value: torch.Tensor) -> torch.Tensor:
    """A host copy of `value` as it is now: the save writes it while the
    next steps update the live tensors in place (whether
    ``dcp.async_save`` stages before it returns depends on torch's version)."""
    return value.detach().to('cpu', copy=True)


def _dcp_save(save_path: str, step: int, model: torch.nn.Module,
              optimizer: torch.optim.Optimizer, extra: Any) -> str:
    import torch.distributed.checkpoint as dcp
    wait_for_async_saves()  # one save in flight at a time
    path = '%s-%d.dcp' % (save_path, step)
    save_dir = os.path.dirname(save_path) or '.'
    tensors, sharded = {}, []
    for name, value in model.state_dict(keep_vars=True).items():
        key = 'model/' + name
        if isinstance(value, mesh.ModelShard):
            sharded.append(key)
            key = _shard_key(key)
        tensors[key] = _host_copy(value)
    state = optimizer.state_dict()
    flat = _flat_params(optimizer)
    for index, buffers in state['state'].items():
        for buf_name, value in buffers.items():
            if not torch.is_tensor(value):
                raise TypeError('orbax backend: optimizer state %s/%s is a %s'
                                % (index, buf_name, type(value).__name__))
            key = 'optimizer/%d/%s' % (index, buf_name)
            if _is_shard_buffer(flat[index], value):
                sharded.append(key)
                key = _shard_key(key)
            tensors[key] = _host_copy(value)
    if mesh.is_primary_worker():
        os.makedirs(path, exist_ok=True)
        torch.save({'step': step, 'param_groups': state['param_groups'], 'extra': extra,
                    'sharded': sharded, 'model_size': mesh.model_size()},
                   os.path.join(path, DCP_META))
    future = dcp.async_save(tensors, checkpoint_id=path, process_group=_dcp_group())
    future = getattr(future, 'upload_completion', future)
    _PENDING.append((future, save_dir, path, step))
    return path


def wait_for_async_saves():
    """Block until the saves in flight are complete, then index them (rank
    0): a checkpoint is indexed only whole.  Call before exit; the next save
    and every restore call it first."""
    while _PENDING:
        future, save_dir, path, step = _PENDING.pop(0)
        future.result()
        if mesh.is_primary_worker():
            _write_index(save_dir, path, step)


def _dcp_load(path: str, map_location=None) -> Dict[str, Any]:
    """The full payload of an 'orbax' checkpoint directory: every shard read
    (by this rank alone) and joined along its last axis."""
    import warnings
    import torch.distributed.checkpoint as dcp
    reader = dcp.FileSystemReader(path)
    metadata = reader.read_metadata().state_dict_metadata
    tensors = {key: torch.empty(tuple(meta.size), dtype=meta.properties.dtype)
               for key, meta in metadata.items()}
    with warnings.catch_warnings():  # "assuming the intent is to load in a single process"
        warnings.simplefilter('ignore', UserWarning)
        dcp.load(tensors, storage_reader=reader, no_dist=True)
    meta = torch.load(os.path.join(path, DCP_META), weights_only=True)
    size = meta['model_size']
    full = {key: torch.cat([tensors['%s/shard%dof%d' % (key, m, size)] for m in range(size)],
                           dim=-1) for key in meta['sharded']}
    full.update({key: value for key, value in tensors.items() if '/shard' not in key})
    device = torch.device(map_location or 'cpu')
    model = {key[len('model/'):]: value.to(device) for key, value in full.items()
             if key.startswith('model/')}
    state = {}
    for key, value in full.items():
        if key.startswith('optimizer/'):
            _, index, buf_name = key.split('/', 2)
            state.setdefault(int(index), {})[buf_name] = value.to(device)
    return {'step': meta['step'], 'model': model,
            'optimizer': {'state': dict(sorted(state.items())),
                          'param_groups': meta['param_groups']},
            'extra': meta['extra']}


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """Path of the newest checkpoint in `save_dir`: the port's, or where it
    has none, the JAX package's ``.msgpack``; None if neither exists."""
    idx = _index_path(save_dir)
    if not os.path.exists(idx):
        idx = os.path.join(save_dir, JAX_INDEX)
        if not os.path.isfile(idx):
            return None
    with open(idx) as fin:
        try:
            meta = json.load(fin)
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            # e.g. a TF1 proto-text 'checkpoint' index of the reference's
            # model zoo tarballs
            raise ValueError(
                "checkpoint index %s is not this framework's JSON format "
                '(TF1 checkpoints from the reference model zoo cannot be '
                'loaded directly): %s' % (idx, exc)) from exc
    path = os.path.join(save_dir, meta['latest'])
    return path if os.path.exists(path) else None


def restore_latest(save_path: str, map_location=None) -> Optional[Dict[str, Any]]:
    """The newest payload saved under `save_path`'s directory, or None; a
    JAX-written checkpoint comes as the port's payload (``payload_from_jax``)."""
    wait_for_async_saves()
    path = latest_checkpoint(os.path.dirname(save_path) or '.')
    if path is None:
        return None
    if path.endswith('.dcp'):
        return _dcp_load(path, map_location)
    if path.endswith('.msgpack'):
        with open(path, 'rb') as fin:
            return payload_from_jax(msgpack_restore(fin.read()), map_location)
    return torch.load(path, map_location=map_location, weights_only=True)


def load_optimizer(optimizer: torch.optim.Optimizer, model: torch.nn.Module, state: Dict):
    """Load a payload's 'optimizer' into `optimizer` over `model`'s
    parameters: the port's own state dict, or a JAX checkpoint's
    ``{'momentum_by_name': {parameter name: buffer}}``, placed as each
    parameter's momentum buffer.  Raises KeyError on a buffer of no
    parameter."""
    momentum = state.get('momentum_by_name')
    flat = _flat_params(optimizer)
    if momentum is None:
        optimizer.load_state_dict(_local_optimizer_state(flat, state))
        return
    names = {id(p): name for name, p in model.named_parameters()}
    target = optimizer.state_dict()
    target['state'] = {}
    for index, param in enumerate(flat):
        if names.get(id(param)) in momentum:
            target['state'][index] = {'momentum_buffer': momentum[names[id(param)]]}
    unplaced = sorted(set(momentum) - {names.get(id(p)) for p in flat})
    if unplaced:
        raise KeyError('checkpoint: momentum of no trained parameter %s' % unplaced)
    optimizer.load_state_dict(_local_optimizer_state(flat, target))


def _local_optimizer_state(flat, state: Dict) -> Dict:
    """An optimizer state dict whose buffers of each ModelShard's full shape
    are cut to this rank's shard (a checkpoint holds the full state)."""
    out = {}
    for index, buffers in state['state'].items():
        param = flat[int(index)] if int(index) < len(flat) else None
        out[index] = {}
        for key, value in buffers.items():
            if isinstance(param, mesh.ModelShard) and torch.is_tensor(value) \
                    and value.dim() == param.dim() and value.shape[-1] != param.shape[-1]:
                value = mesh.shard_tensor(value, mesh.shard(-1))
            out[index][key] = value
    return {**state, 'state': out}


# ---------------------------------------------------------------------------
# the JAX package's msgpack checkpoints
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3  # flax.serialization's ext codes
_FIXED = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
          0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}


class _Reader:
    """A msgpack decoder over one buffer: ``value()`` reads the next object."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError('msgpack: truncated at byte %d' % self.pos)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        tag = self.unpack('>B')
        if tag <= 0x7f:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8f:
            return self.mapping(tag & 0x0f)
        if 0x90 <= tag <= 0x9f:
            return [self.value() for _ in range(tag & 0x0f)]
        if 0xa0 <= tag <= 0xbf:
            return str(self.take(tag & 0x1f), 'utf-8')
        if tag in _FIXED:
            return self.unpack(_FIXED[tag])
        if tag == 0xc0:
            return None
        if tag in (0xc2, 0xc3):
            return tag == 0xc3
        if tag in (0xc4, 0xc5, 0xc6):  # bin 8/16/32
            return bytes(self.take(self.unpack('>' + 'BHI'[tag - 0xc4])))
        if tag in (0xd9, 0xda, 0xdb):  # str 8/16/32
            return str(self.take(self.unpack('>' + 'BHI'[tag - 0xd9])), 'utf-8')
        if tag in (0xdc, 0xdd):  # array 16/32
            return [self.value() for _ in range(self.unpack('>' + 'HI'[tag - 0xdc]))]
        if tag in (0xde, 0xdf):  # map 16/32
            return self.mapping(self.unpack('>' + 'HI'[tag - 0xde]))
        if tag in (0xc7, 0xc8, 0xc9):  # ext 8/16/32: size, then type
            size = self.unpack('>' + 'BHI'[tag - 0xc7])
            return _ext(self.unpack('>b'), bytes(self.take(size)))
        if 0xd4 <= tag <= 0xd8:  # fixext 1/2/4/8/16: type, then data
            code = self.unpack('>b')
            return _ext(code, bytes(self.take(1 << (tag - 0xd4))))
        raise ValueError('msgpack: unknown type byte 0x%02x at byte %d' % (tag, self.pos - 1))

    def mapping(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ndarray(data: bytes):
    """flax's ndarray ext: msgpack of (shape, dtype name, C-order bytes).
    bfloat16 (which numpy lacks) comes as a torch.bfloat16 tensor."""
    shape, dtype, buffer = _Reader(data).value()
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == 'bfloat16':
        bits = np.frombuffer(buffer, np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype)).reshape(shape)


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        value = _ndarray(data)
        return value[()] if isinstance(value, np.ndarray) else value.reshape(())
    if code == _EXT_COMPLEX:
        real, imag = _Reader(data).value()
        return complex(real, imag)
    raise ValueError('msgpack: ext type %d is not one flax writes' % code)


def _unchunk(tree):
    """flax's chunked leaves ({'__msgpack_chunked_array__': True, 'shape':
    {'0': ...}, 'chunks': {'0': ...}}) joined back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if '__msgpack_chunked_array__' in tree:
        shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        if torch.is_tensor(chunks[0]):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in tree.items()}


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` reads from `data`:
    dicts, lists and scalars, numpy array leaves (torch.bfloat16 tensors for
    bfloat16 leaves)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError('msgpack: %d bytes after the object' % (len(reader.data) - reader.pos))
    return _unchunk(tree)


def _float32_tree(tree):
    """A tree with every leaf a float32 numpy array (bfloat16 tensors widened)."""
    if isinstance(tree, dict):
        return {key: _float32_tree(value) for key, value in tree.items()}
    if torch.is_tensor(tree):
        return tree.to(torch.float32).numpy()
    return np.asarray(tree, np.float32)


def _find(tree, key: str):
    """The first subtree of `tree` (depth first) under `key`, or None."""
    if not isinstance(tree, dict):
        return None
    if key in tree:
        return tree[key]
    for value in tree.values():
        found = _find(value, key)
        if found is not None:
            return found
    return None


def payload_from_jax(tree: Dict[str, Any], map_location=None) -> Dict[str, Any]:
    """The port's payload of a JAX ``TrainState`` tree: 'step', 'model' (the
    state dict, through the bridge), 'optimizer' (``{'momentum_by_name':
    ...}`` from optax's trace) and 'extra' (``extra_from_jax``), tensors on
    `map_location` (default the CPU)."""
    from pocketflow_tpu_torch.core import bridge
    device = torch.device(map_location or 'cpu')
    state_dict, buffers = bridge.from_jax_numpy(_float32_tree(tree['params']),
                                                _float32_tree(tree.get('batch_stats') or {}))
    trace = _find(tree.get('opt_state'), 'trace')
    momentum = bridge.from_jax_numpy(_float32_tree(trace), {})[0] if trace else {}
    extra = tree.get('extra')
    return {'step': int(np.asarray(tree['step'])),
            'model': {k: v.to(device) for k, v in {**state_dict, **buffers}.items()},
            'optimizer': {'momentum_by_name': {k: v.to(device) for k, v in momentum.items()}},
            'extra': None if extra is None else bridge.extra_from_jax(extra, device)}


def restore_intersecting(save_path: str, model: torch.nn.Module,
                         prefix_map: Optional[Dict[str, str]] = None) -> int:
    """Copy into `model`, in place, every parameter of the newest checkpoint
    under `save_path`'s directory whose path and shape match one of its
    parameters; the rest keep their values.  Paths are Flax-style
    ('stage1_block0/conv1/kernel'); `prefix_map` rewrites a source prefix
    first (the first that matches; {'': 'backbone/'} puts a classification
    trunk under 'backbone/').  Parameters only, as the JAX package grafts
    its 'params' tree; a tensor-parallel shard takes its slice of a full
    match.  Returns the number of tensors copied (0 without a
    checkpoint)."""
    payload = restore_latest(save_path, map_location='cpu')
    if payload is None:
        return 0
    src = {}
    for key, value in payload['model'].items():
        key = key.replace('.', '/')
        for old, new in (prefix_map or {}).items():
            if key.startswith(old):
                key = new + key[len(old):]
                break
        src[key] = value
    from pocketflow_tpu_torch.nn import layers
    count = 0
    with torch.no_grad():
        for name, param in model.named_parameters():
            cand = src.get(name.replace('.', '/'))
            if cand is None or tuple(cand.shape) != layers.full_shape(name, param):
                continue
            if isinstance(param, mesh.ModelShard):  # a tensor-parallel shard: its slice
                cand = mesh.shard_tensor(cand, mesh.shard(-1))
            param.copy_(cand)
            count += 1
    return count
