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
(numpy has no bfloat16).  The orbax backend is not read.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from pocketflow_tpu_torch.core import mesh

INDEX = 'checkpoint.json'
JAX_INDEX = 'checkpoint'  # pocketflow_tpu/core/checkpoint.py's index file


def _index_path(save_dir: str) -> str:
    return os.path.join(save_dir, INDEX)


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
    tmp_index = _index_path(save_dir) + '.tmp'
    with open(tmp_index, 'w') as fout:
        json.dump({'latest': os.path.basename(path), 'step': step}, fout)
    os.replace(tmp_index, _index_path(save_dir))
    return path


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
    path = latest_checkpoint(os.path.dirname(save_path) or '.')
    if path is None:
        return None
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
    if momentum is None:
        optimizer.load_state_dict(state)
        return
    names = {id(p): name for name, p in model.named_parameters()}
    flat = [p for group in optimizer.param_groups for p in group['params']]
    target = optimizer.state_dict()
    target['state'] = {}
    for index, param in enumerate(flat):
        if names.get(id(param)) in momentum:
            target['state'][index] = {'momentum_buffer': momentum[names[id(param)]]}
    unplaced = sorted(set(momentum) - {names.get(id(p)) for p in flat})
    if unplaced:
        raise KeyError('checkpoint: momentum of no trained parameter %s' % unplaced)
    optimizer.load_state_dict(target)


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
    its 'params' tree.  Returns the number of tensors copied (0 without a
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
    count = 0
    with torch.no_grad():
        for name, param in model.named_parameters():
            cand = src.get(name.replace('.', '/'))
            if cand is not None and tuple(cand.shape) == tuple(param.shape):
                param.copy_(cand)
                count += 1
    return count
